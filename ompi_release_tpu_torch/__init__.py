"""ompi_release_tpu_torch — the PyTorch/CUDA port of ``ompi_release_tpu``.

Same Open MPI 1.8.5-shaped surface as the JAX package (MCA config and
components, runtime bring-up, communicators, named collective
algorithms), written in PyTorch for an NVIDIA H100. The JAX package
stays beside it as the reference the port is tested against; this
package imports ``torch`` and numpy and nothing of JAX or of
``ompi_release_tpu``.

Driver-mode contract (as in ``ompi_release_tpu/coll/driver.py``):
collectives take one buffer whose leading axis is the communicator
size, row r being rank r's buffer. N virtual ranks share one device
(``runtime_virtual_ranks`` cvar); entry points run on ``cuda:0`` unless
the caller passes ``device="cpu"``.

Layering follows the JAX package: ``mca``/``utils`` (config, components,
logging), ``runtime`` (bring-up, state machine), ``datatype`` (derived
datatypes, pack/unpack), ``ops`` (reduction ops and the hand-written
CUDA kernels), ``comm`` (intra- and intercommunicators), ``coll``
(components, frozen plans, nonblocking and persistent collectives),
``topo`` (cartesian and graph topologies), ``tuning`` (the
per-topology tuning database), ``osc`` (one-sided windows with frozen
epoch plans), ``oshmem`` (OpenSHMEM), ``io`` (MPI-IO files and sharded
arrays) and ``ft`` (checkpoints); ``parallel`` and ``models`` carry the
model family.
"""

from . import mca, utils
from .utils.errors import ErrorCode, MPIError

__version__ = "0.1.0"

_LAZY = {"runtime", "datatype", "ops", "comm", "coll", "parallel", "models",
         "tuning", "topo", "osc", "oshmem", "io", "ft"}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def init(*, cli_args=None, device=None):
    """Bring up the runtime (the ``MPI_Init`` analogue) and return the
    WORLD communicator. ``device`` defaults to ``cuda:0``; pass
    ``device="cpu"`` to run on the host."""
    from .runtime import init as _rt_init

    return _rt_init(cli_args=cli_args, device=device)


def finalize():
    from .runtime import finalize as _rt_finalize

    return _rt_finalize()


def initialized() -> bool:
    """MPI_Initialized."""
    from .runtime.runtime import Runtime

    return Runtime.is_initialized()


def finalized() -> bool:
    """MPI_Finalized."""
    from .runtime.runtime import Runtime

    rt = Runtime._instance
    return bool(rt is not None and rt.finalized)


def wtime() -> float:
    """MPI_Wtime: monotonic wall-clock seconds."""
    import time

    return time.monotonic()


def wtick() -> float:
    """MPI_Wtick: the wtime clock's resolution."""
    import time

    return time.get_clock_info("monotonic").resolution


def get_version():
    """MPI_Get_version analogue: (framework version, reference level),
    the JAX package's capability level (the Open MPI 1.8.5-era
    surface)."""
    return __version__, "ompi-1.8.5-capability"


def error_string(code) -> str:
    """MPI_Error_string: human text for an error class."""
    try:
        return ErrorCode(code).name
    except ValueError:
        return f"unknown error code {code}"

"""Runtime layer (ORTE analogue): bootstrap, rank mapping, state machine,
modex."""

from .state import JobState, ProcState, StateMachine
from .mesh import Endpoint, Mesh, build_mesh, factorize_torus, run_modex
from .runtime import Runtime, finalize, init
from .ess import ESS_FRAMEWORK

__all__ = [
    "JobState", "ProcState", "StateMachine",
    "Endpoint", "Mesh", "build_mesh", "factorize_torus", "run_modex",
    "Runtime", "init", "finalize", "ESS_FRAMEWORK",
]

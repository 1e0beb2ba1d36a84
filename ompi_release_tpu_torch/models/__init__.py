"""The model family: the flagship ``transformer.TpuLM`` (dense or
switch-MoE) and the ``mixer.TpuMixer``, each with its eval forward and
train step, on one device or sharded over a mesh of virtual ranks.

Counterpart of ``ompi_release_tpu/models``.
"""

from . import mixer  # noqa: F401
from .mixer import MixerConfig, TpuMixer  # noqa: F401
from .transformer import (  # noqa: F401
    ModelConfig, TpuLM, forward_loss, init_params, make_forward,
    make_train_step, param_shapes, param_specs, params_from_jax,
    shard_params,
)

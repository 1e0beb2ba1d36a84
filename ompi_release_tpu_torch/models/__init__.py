"""The model family on one card: the flagship ``transformer.TpuLM``
(dense or switch-MoE) and the ``mixer.TpuMixer``, each with its eval
forward and train step.

Counterpart of ``ompi_release_tpu/models``.
"""

from . import mixer  # noqa: F401
from .mixer import MixerConfig, TpuMixer  # noqa: F401
from .transformer import (  # noqa: F401
    ModelConfig, TpuLM, forward_loss, init_params, make_forward,
    make_train_step, param_shapes, params_from_jax,
)

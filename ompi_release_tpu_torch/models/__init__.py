"""The flagship model (``transformer.TpuLM``): eval forward and train
step on one card.

Counterpart of ``ompi_release_tpu/models``; the MLP-Mixer and the
switch-MoE TpuLM come with ROADMAP slice 3 item 15.
"""

from .transformer import (  # noqa: F401
    ModelConfig, TpuLM, forward_loss, init_params, make_forward,
    make_train_step, param_shapes, params_from_jax,
)

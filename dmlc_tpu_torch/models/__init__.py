"""Models of the port: the flagship decoder LM, trained on one card or on
a pp × dp × sp × ep × tp mesh (``transformer``), and served on the
paged decode path or the gather path (``forward_decode``,
``forward_decode_spec``); weights and train state to and from the JAX
package's trees (``convert``)."""

from .transformer import (  # noqa: F401
    PARAM_SPECS,
    SHARDED_AXES,
    Transformer,
    TransformerConfig,
    adamw,
    count_params,
    decode_phase_flops,
    flagship_config,
    forward_decode,
    forward_decode_spec,
    forward_local,
    init_params,
    make_train_step,
    sharded_grad_norm,
    sync_gradients,
    train_flops_per_token,
    train_step_flops,
    unsharded_loss,
)

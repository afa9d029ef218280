"""The port's language models, for serving and training: the GQA
transformer (dense, moe, vlm), Mamba2 (ssm), the Zamba2 hybrid and the
encoder-decoder (encdec)."""
from repro_torch.models.convert import (init_params, params_from_jax,
                                        state_from_jax)
from repro_torch.models.registry import (batch_specs, decode_specs,
                                        get_model, input_specs,
                                        make_concrete_batch)

__all__ = ["get_model", "make_concrete_batch", "batch_specs",
           "decode_specs", "input_specs", "init_params",
           "params_from_jax", "state_from_jax"]

"""The port's language models (dense GQA transformer and Mamba2) for the
serving path; the other families wait (ROADMAP A8)."""
from repro_torch.models.convert import init_params, params_from_jax
from repro_torch.models.registry import get_model, make_concrete_batch

__all__ = ["get_model", "make_concrete_batch", "init_params",
           "params_from_jax"]

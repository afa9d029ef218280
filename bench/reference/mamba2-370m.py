"""Plain reference of the mamba2-370m configuration: ``n_layers`` Mamba2
blocks (SSD, arXiv:2405.21060) on a pre-norm residual, a final RMS norm
and the output head tied to the embedding."""
from bench.reference import blocks as R


def logits(params, model: dict, tokens, at, m: R.Matmul):
    """float32 logits [len(at), V_padded] of ``tokens`` [S] at positions
    ``at`` (a list), for ``params`` (the port's parameter layout)."""
    d, eps = model["d_model"], model.get("norm_eps", 1e-5)
    mamba = dict(d_inner=model.get("ssm_expand", 2) * d,
                 n=model["ssm_state"], headdim=model["ssm_headdim"],
                 conv=model.get("ssm_conv", 4), eps=eps)
    x = params["embed"][tokens].float()
    for lp in params["layers"]:
        x = x + R.mamba2_block(lp["m"], R.rms_norm(x, lp["ln"], eps), m,
                               **mamba)
    x = R.rms_norm(x[at], params["final_norm"], eps)
    head = params["embed"].T if model.get("tie_embeddings") else \
        params["unembed"]
    return m(x, head)

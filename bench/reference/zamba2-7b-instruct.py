"""Plain reference of the zamba2-7b-instruct configuration
(Zyphra/Zamba2-7B-Instruct, arXiv:2411.15242): ``n_layers`` Mamba2 layers
(``bench.reference.zamba2.mamba2_grouped``) on a pre-norm residual; before
the Mamba block of each layer in ``hybrid_layer_ids`` one of the
``n_shared`` alternating shared blocks (application j: block j % n_shared,
with application j's adapter and ``linear``) reads [x, embeddings], and
its output is added to that Mamba block's input, not to the residual; a
final RMS norm and the head tied to the embedding.  Computed a layer at a
time on the whole sequence."""
from bench.reference import blocks as R
from bench.reference import zamba2 as Z


def logits(params, model: dict, tokens, at, m: R.Matmul):
    """float32 logits [len(at), V_padded] of ``tokens`` [S] at positions
    ``at`` (a list), for ``params`` (the port's parameter layout)."""
    d, eps = model["d_model"], model.get("norm_eps", 1e-5)
    mamba = dict(d_inner=model.get("ssm_expand", 2) * d,
                 n=model["ssm_state"], headdim=model["ssm_headdim"],
                 conv=model.get("ssm_conv", 4),
                 groups=model.get("ssm_groups", 1), eps=eps)
    head_dim = model["head_dim"]
    shared = dict(heads=model["n_heads"], kv_heads=model["n_kv_heads"],
                  head_dim=head_dim,
                  scale=model.get("attn_scale") or head_dim ** -0.5,
                  theta=model.get("rope_theta", 10000.0), d_ff=model["d_ff"],
                  eps=eps)
    n_shared = model.get("n_shared", 2)
    app = {i: j for j, i in enumerate(model["hybrid_layer_ids"])}
    e = params["embed"][tokens].float()
    x = e
    for i, lp in enumerate(params["layers"]):
        h = x
        if i in app:
            j = app[i]
            h = x + Z.shared_block(params["shared"][j % n_shared],
                                   params["apps"][j], x, e, m, **shared)
        x = x + Z.mamba2_grouped(lp["m"], R.rms_norm(h, lp["ln"], eps), m,
                                 **mamba)
    x = R.rms_norm(x[at], params["final_norm"], eps)
    head = params["embed"].T if model.get("tie_embeddings") else \
        params["unembed"]
    return m(x, head)

"""The plain references agree with the program's CPU path on the tiny
configurations: the prefill's last logits and three decode steps through
the program's cache, against one reference pass over the prompt and the
tokens fed."""
import dataclasses

import pytest
import torch

from portbench.check import reference
from portbench.tests.tiny import DENSE, MOE
from portbench.weights import make_weights, shapes_of


def _both(config, cache="float32", wire="float32", T=24, steps=3, B=2,
          seed=4):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.launch.serve import grow_cache
    from repro_torch.models.api import ModelAPI
    cfg = get_config(config["port"]["arch"]).replace(attn_impl="flash",
                                                     kv_cache_dtype=cache)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  dispatch_dtype=wire))
    api, mctx = (ModelAPI(cfg, device="cpu"),
                 make_host_mesh_ctx(cfg, device="cpu"))
    w = make_weights(shapes_of(api.param_defs()), seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (B, T), generator=g)
    fed = torch.randint(0, cfg.vocab, (B, steps), generator=g)
    with torch.inference_mode():
        logits, kv = api.prefill(w, {"tokens": toks}, mctx)
        kv = grow_cache(kv, cfg.family, steps)
        got = [logits]
        for i in range(steps):
            pos = torch.full((B,), T + i, dtype=torch.int32)
            lg, _ = api.decode(w, {"token": fed[:, i].to(torch.int32),
                                   "pos": pos}, kv, mctx)
            got.append(lg)
        shape, forward = reference(config)
        want = torch.stack([forward(w, shape, torch.cat([toks[b], fed[b]]),
                                    T - 1) for b in range(B)])
    got = torch.stack(got, 1).float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("config", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_matches_the_program_in_float32(config):
    assert _both(config) < 1e-4


@pytest.mark.parametrize("config", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_matches_the_program_as_configured(config):
    """The tiny configs' own bfloat16 cache (and dispatch wire): bf16's
    rounding of k and v, and of the experts' payload."""
    assert _both(config, cache="bfloat16", wire="bfloat16") < 2e-2

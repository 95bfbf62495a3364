"""The port's serving engine against the reference's (tests/test_serve.py):
the same params and prompts give the same greedy tokens (dense, moe,
hybrid and ssm families); partial waves exit early; prompts round-trip through
the port's store on the CPU."""
import numpy as np
import pytest
import torch

import jax

from repro.configs import tiny_config as ref_tiny_config
from repro.core.client import ROS2Client as RefClient
from repro.launch.mesh import make_host_mesh_ctx as ref_host_ctx
from repro.launch.serve import BatchedEngine as RefEngine
from repro.launch.serve import Request as RefRequest
from repro.launch.serve import read_prompt as ref_read_prompt
from repro.launch.serve import write_prompts as ref_write_prompts
from repro.models.api import ModelAPI as RefAPI
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import tiny_config
from repro_torch.core.client import ROS2Client
from repro_torch.launch.mesh import make_host_mesh_ctx
from repro_torch.launch.serve import (BatchedEngine, Request, read_prompt,
                                      write_prompts)
from repro_torch.models.api import ModelAPI
from repro_torch.models.params import params_from_numpy

PLEN, MAXNEW, BATCH = 16, 6, 3


def _engines(name="granite-3-2b", impl="jnp"):
    ref_cfg = ref_tiny_config(name).replace(attn_impl=impl)
    ref_api = RefAPI(ref_cfg)
    ref_params = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(0))
    ref_eng = RefEngine(ref_api, ref_params, ref_host_ctx(ref_cfg),
                        batch=BATCH, prompt_len=PLEN,
                        max_seq=PLEN + MAXNEW + 8)
    cfg = tiny_config(name).replace(attn_impl=impl)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    eng = BatchedEngine(ModelAPI(cfg, device="cpu"), params,
                        make_host_mesh_ctx(cfg, device="cpu"), batch=BATCH,
                        prompt_len=PLEN, max_seq=PLEN + MAXNEW + 8)
    return ref_eng, eng


def _prompts(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, PLEN, dtype=np.int32) for _ in range(n)]


def test_wave_matches_reference_engine():
    ref_eng, eng = _engines()
    prompts = _prompts(0, BATCH, eng.api.cfg.vocab)
    reqs = [Request(i, p, MAXNEW) for i, p in enumerate(prompts)]
    ref_reqs = [RefRequest(i, p, MAXNEW) for i, p in enumerate(prompts)]
    eng.run_wave(reqs)
    ref_eng.run_wave(ref_reqs)
    for r, rr in zip(reqs, ref_reqs):
        assert len(r.out) == MAXNEW
        assert r.out == rr.out, (r.rid, r.out, rr.out)
    assert (eng.steps, eng.slot_steps, eng.active_slot_steps) == (
        ref_eng.steps, ref_eng.slot_steps, ref_eng.active_slot_steps)
    assert eng.prefill_s > 0 and eng.decode_s > 0


@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_families_give_the_reference_engines_tokens(name, impl):
    """A partial wave of the hybrid and ssm families: their O(1) state
    passes _pad_cache unchanged in both engines, and every greedy token
    is the reference's."""
    ref_eng, eng = _engines(name, impl)
    p0, p1 = _prompts(2, 2, eng.api.cfg.vocab)
    reqs = [Request(0, p0, MAXNEW), Request(1, p1, 3)]
    ref_reqs = [RefRequest(0, p0, MAXNEW), RefRequest(1, p1, 3)]
    eng.run_wave(reqs)
    ref_eng.run_wave(ref_reqs)
    assert [len(r.out) for r in reqs] == [MAXNEW, 3]
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert (eng.steps, eng.active_slot_steps) == (
        ref_eng.steps, ref_eng.active_slot_steps)


@pytest.mark.parametrize("impl", ["jnp", "flash"])
@pytest.mark.parametrize("name", ["dbrx-132b", "deepseek-v2-236b"])
def test_moe_family_gives_the_reference_engines_tokens(name, impl):
    """A partial wave of the moe family (GQA k/v caches for dbrx, MLA's
    latent and rotary-key caches for deepseek-v2) through both engines'
    prefill, _pad_cache and decode: every greedy token is the
    reference's."""
    ref_eng, eng = _engines(name, impl)
    p0, p1 = _prompts(3, 2, eng.api.cfg.vocab)
    reqs = [Request(0, p0, MAXNEW), Request(1, p1, 4)]
    ref_reqs = [RefRequest(0, p0, MAXNEW), RefRequest(1, p1, 4)]
    eng.run_wave(reqs)
    ref_eng.run_wave(ref_reqs)
    assert [len(r.out) for r in reqs] == [MAXNEW, 4]
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert (eng.steps, eng.active_slot_steps) == (
        ref_eng.steps, ref_eng.active_slot_steps)


def test_partial_wave_and_early_exit():
    ref_eng, eng = _engines()
    p0, p1 = _prompts(1, 2, eng.api.cfg.vocab)
    reqs = [Request(0, p0, 2), Request(1, p1, MAXNEW)]
    ref_reqs = [RefRequest(0, p0, 2), RefRequest(1, p1, MAXNEW)]
    eng.run_wave(reqs)            # wave smaller than batch; mixed lengths
    ref_eng.run_wave(ref_reqs)
    assert len(reqs[0].out) == 2
    assert len(reqs[1].out) == MAXNEW
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]
    assert eng.active_slot_steps <= eng.slot_steps
    assert eng.active_slot_steps == ref_eng.active_slot_steps
    with pytest.raises(ValueError):
        eng.run_wave([])


def test_pad_cache_grows_the_sequence_axis_when_prompt_len_equals_layers():
    """The stacked cache is (L,B,S,KH,D): padding goes to S even when the
    prompt length equals the layer count (ROADMAP Queue 3)."""
    _, eng = _engines()
    n_layers = eng.api.cfg.n_layers
    eng.prompt_len, eng.max_seq = n_layers, n_layers + 5
    cache = {"k": torch.ones(n_layers, BATCH, n_layers, 2, 16)}
    grown = eng._pad_cache(cache)["k"]
    assert tuple(grown.shape) == (n_layers, BATCH, n_layers + 5, 2, 16)
    assert torch.equal(grown[:, :, :n_layers], cache["k"])
    assert not grown[:, :, n_layers:].any()


def test_pad_cache_grows_mla_caches_by_position():
    """MLA's (L,B,S,r) latent and (L,B,S,rope) rotary-key caches grow on
    axis 2. Where the prompt length equals the layer count the reference
    pads the first axis of that size, the layer axis, and the port still
    pads the sequence axis."""
    ref_eng, eng = _engines("deepseek-v2-236b")
    cfg = eng.api.cfg
    n, m = cfg.n_layers, cfg.mla
    for e in (eng, ref_eng):
        e.prompt_len, e.max_seq = n, n + 5
    shapes = {"ckv": (n, BATCH, n, m.kv_lora_rank),
              "krope": (n, BATCH, n, m.qk_rope_head_dim)}
    cache = {k: torch.ones(s) for k, s in shapes.items()}
    grown = eng._pad_cache(cache)
    ref_grown = ref_eng._pad_cache({k: np.ones(s, np.float32)
                                    for k, s in shapes.items()})
    for key, (L, B, S, r) in shapes.items():
        assert tuple(grown[key].shape) == (L, B, S + 5, r)
        assert torch.equal(grown[key][:, :, :S], cache[key])
        assert not grown[key][:, :, S:].any()
        assert ref_grown[key].shape == (L + 5, B, S, r)


def test_prompts_roundtrip_through_store():
    c = ROS2Client(mode="dpu", transport="rdma", device="cpu")
    ref = RefClient(mode="dpu", transport="rdma")
    try:
        write_prompts(c, 3, PLEN, 100, seed=5)
        ref_write_prompts(ref, 3, PLEN, 100, seed=5)
        p0 = read_prompt(c, 0, PLEN)
        p1 = read_prompt(c, 1, PLEN)
        assert p0.shape == (PLEN,) and p1.shape == (PLEN,)
        assert not np.array_equal(p0, p1)
        for rid in range(3):
            np.testing.assert_array_equal(read_prompt(c, rid, PLEN),
                                          ref_read_prompt(ref, rid, PLEN))
    finally:
        c.close()
        ref.close()


def test_serve_main_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])

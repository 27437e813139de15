"""Tensor-parallel serving (a 'model' axis above 1) == one device.

The port's counterpart of ``tests/test_sharded_serve.py``'s
``test_tensor_parallel_mesh_bit_equal``, on the CPU: ONE spawn of four gloo
ranks (``launch.mesh.spawn``) serves every case on a (2, 2) and then a
(1, 4) mesh, and the parent runs each case on one device.  The reduced
granite-8b (4 heads over 2 KV heads, vocabulary 251 padded to 256) under
the reference's own ``MIXED_LM`` plan and inputs: ``rng(3)`` prompts (4, 8)
and 5 new tokens, so the cache length of 13 is odd against the split.

Contract (README, "Tensor-parallel serving"): prefill and decode logits
bitwise the single-device port's (the split-sequence decode runs the
one-device routine on all-gathered scores and V; here the cache length
rounded up to the model axis, 14 or 16, is longer than one device's 13,
and the masked tail adds exact zeros); generated tokens equal the
single-device port's and ``repro``'s ``Generator`` on the same weights;
every rank holds the same logits, bitwise.  The packed KV cache,
speculative decoding, the ``GenerateScheduler`` and the ResNet
(replicated over 'model') are held against the single-device port the
same way.  Unit tests: K1's accumulator-only plain twin, the row shards'
int32 sum, the vocabulary shards of the embedding and the head, and the
split-sequence decode against the one-device decode attention.

The module imports no JAX at its top: the spawned ranks import it to find
the case functions; ``repro``'s side runs once, in a fixture.  Every
process computes on one thread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core import packing
from repro_torch.core.plan import KVCachePlan, LayerPlan, PrecisionPlan
from repro_torch.kernels.mpmm import epilogue, kernel, ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import resnet as R
from repro_torch.models import transformer as T
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.runtime.scheduler import GenerateScheduler
from repro_torch.runtime.serve import (Generator, ImageServer,
                                       pack_for_serving)
from repro_torch.runtime.specdec import SpeculativeGenerator

WORLD = 4
MESHES = ((2, 2), (1, 4))
PLANS = "examples/plans"
FORMATS = [(w, k) for w in (1, 2, 4, 8) for k in (1, 2, 4, 8)]
PROMPTS, NEW = (4, 8), 5

MIXED_LM = {"q": {"w_bits": 4, "k": 4}, "mlp": {"w_bits": 2, "k": 2}}
MIXED_CNN = PrecisionPlan.build(
    {"s0b0c1": LayerPlan(w_bits=4, k=4),
     "s0b0c2": LayerPlan(w_bits=2, k=2),
     "s1b0p": LayerPlan(w_bits=4, k=4)},
    default=LayerPlan(w_bits=8, k=4), name="test_mixed_cnn",
    arch="resnet18")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _plan(layers=MIXED_LM, kv_store=None):
    plan = PrecisionPlan.build(
        {k: LayerPlan(**v) for k, v in layers.items()},
        default=LayerPlan(w_bits=8, k=4), name="test_tp",
        arch="granite-8b")
    if kv_store is not None:
        plan = dataclasses.replace(plan, kv=KVCachePlan(k=4, store=kv_store))
    return plan


KV_LAYERS = {**MIXED_LM, "k": {"w_bits": 8, "kv_bits": 4},
             "v": {"w_bits": 8, "kv_bits": 2},
             "l1.k": {"w_bits": 8, "kv_bits": 8}}


def _prompts(vocab):
    return np.asarray(np.random.default_rng(3).integers(
        0, vocab, PROMPTS), np.int32)


def _api(plan):
    return configs.get("granite-8b", reduced=True, policy=plan)


# --- the cases: each runs on ``mesh`` (None: one device) -> its results -----


def case_lm(mesh, train):
    api = _api(_plan())
    gen = Generator(api=api, params=pack_for_serving(api, train, mesh=mesh),
                    device="cpu", mesh=mesh)
    toks, logits = gen.run(_prompts(api.cfg.vocab), NEW)
    out = {"tokens": toks, "logits": [lg.float().numpy() for lg in logits]}
    if mesh is not None:
        cache = gen._grow_cache(gen.prefill(torch.as_tensor(
            _prompts(api.cfg.vocab)[:2], dtype=torch.long))[1], 2, 8, 13)
        out["per_rank"] = {
            "head_cols": gen.params["head"]["planes"].shape[-1],
            "o_rows": gen.params["layers"][0]["attn"]["o"]["planes"]
            .shape[-2],
            "kv_seq": cache[0][0].shape[1],
            "prompt_block": cache[0][0][:, :, 0, 0].float().numpy()}
    return out


def case_kv(mesh, train):
    out = {}
    for store in ("packed", "qdq"):
        api = _api(_plan(KV_LAYERS, store))
        gen = Generator(api=api, params=pack_for_serving(api, train,
                                                         mesh=mesh),
                        device="cpu", mesh=mesh)
        toks, logits = gen.run(_prompts(api.cfg.vocab), NEW)
        out[store] = {"tokens": toks,
                      "logits": [lg.float().numpy() for lg in logits]}
    return out


def case_specdec(mesh, train):
    verify = PrecisionPlan.load(f"{PLANS}/granite_8b_mixed.json")
    draft = PrecisionPlan.load(f"{PLANS}/granite_8b_draft_w2.json")
    api = _api(verify)
    views = tuple(pack_for_serving(dataclasses.replace(api, policy=p), train,
                                   mesh=mesh) for p in (verify, draft))
    sg = SpeculativeGenerator(api=api, packed_views=views, draft_plan=draft,
                              k=3, device="cpu", mesh=mesh)
    toks = sg.generate(_prompts(api.cfg.vocab)[:3, :6], 7)
    return {"tokens": toks, "drafted": sg.drafted_tokens,
            "accepted": sg.accepted_tokens}


def case_scheduler(mesh, train):
    api = _api(_plan())
    gen = Generator(api=api, params=pack_for_serving(api, train, mesh=mesh),
                    device="cpu", mesh=mesh)
    sched = GenerateScheduler(gen, slots=4, max_len=15, clock=FakeClock())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, api.cfg.vocab, (n,)).astype(np.int32)
               for n in (6, 6, 4, 6)]
    tickets = [sched.submit(p, n) for p, n in zip(prompts, (3, 5, 2, 4))]
    sched.run_until_idle()
    return {"results": [t.result for t in tickets],
            "alone": [gen.generate(p.reshape(1, -1), n)[0]
                      for p, n in zip(prompts, (3, 5, 2, 4))]}


def case_resnet(mesh, train):
    del train
    api = configs.get("resnet18", reduced=True)
    params = api.init_params(torch.Generator().manual_seed(0), device="cpu")
    state = R.init_bn_state(R.specs(api.cfg), device="cpu")
    packed = R.pack_for_serve(api.cfg, params, state, MIXED_CNN)
    srv = ImageServer(api=api, params=packed, plan=MIXED_CNN,
                      batch_buckets=(8,), device="cpu", mesh=mesh)
    images = np.random.default_rng(0).normal(
        0.4, 0.5, (7, 32, 32, 3)).astype(np.float32)
    return {"logits": srv.predict(images)}


def case_embed_head(mesh, train):
    """The vocabulary shards of the embedding and the head against the
    whole tree's, on every rank."""
    api = _api(_plan())
    whole = pack_for_serving(api, train)
    local = pack_for_serving(api, train, mesh=mesh)
    ids = torch.as_tensor(np.random.default_rng(1).integers(
        0, api.cfg.vocab, (3, 9)))
    x = torch.as_tensor(np.random.default_rng(2).normal(
        0, 1, (3, 2, api.cfg.d_model)), dtype=torch.bfloat16)
    tp = T._tp_mesh(api.cfg, mesh) if mesh is not None else None
    out = {"embed": L.embed_serve_apply(local["embed"], ids, mesh=tp)
           .float().numpy(),
           "head": T._head(api.cfg, local, x, api.policy, "auto", mesh=tp)
           .float().numpy()}
    if mesh is not None:
        out["per_rank"] = {"embed_rows": local["embed"]["codes"].shape[0],
                           "whole_rows": whole["embed"]["codes"].shape[0]}
    return out


def case_split_decode(mesh, train):
    """``nn.attention._split_decode`` of three queries over this rank's
    block of a cache, bf16 and packed."""
    del train
    g = torch.Generator().manual_seed(4)
    b, s, kvh, h, d = 2, 16, 2, 4, 16
    q = torch.randn(b, 3, h, d, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, kvh, d, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, kvh, d, generator=g).to(torch.bfloat16)
    if mesh is None:
        return {"q": q, "k": k, "v": v}
    r, m = mesh_lib.model_coords(mesh)
    blk = s // m
    sl = slice(r * blk, (r + 1) * blk)
    h_l = h // m
    q_l = q[:, :, r * h_l:(r + 1) * h_l]
    from repro_torch.nn import kvcache
    fmt = kvcache.KVFormat(4, 4, d)
    kq, vq = kvcache.pack_kv(k, fmt), kvcache.pack_kv(v, fmt)
    block = lambda t: {"p": t["p"][:, :, sl], "s": t["s"][:, sl],  # noqa
                       "z": t["z"][:, sl]}
    return {"bf16": A._split_decode(q_l, k[:, sl], v[:, sl], None, None, 9,
                                    None, mesh, streamed=False).float()
            .numpy(),
            "packed": A._split_decode(q_l, block(kq), block(vq), fmt, fmt,
                                      9, None, mesh, streamed=True).float()
            .numpy(),
            "per_rank": {"heads": (r * h_l, (r + 1) * h_l)}}


CASES = {f.__name__[5:]: f for f in (
    case_lm, case_kv, case_specdec, case_scheduler, case_resnet,
    case_embed_head, case_split_decode)}


def _rank(rank, np_train):
    """One rank: every case on each of ``MESHES`` -> {shape: {case:
    results}}."""
    torch.set_num_threads(1)
    train = convert.from_jax_lm_train_params(np_train, device="cpu")
    out = {}
    for shape in MESHES:
        mesh = mesh_lib.make_serve_mesh(*shape, device="cpu")
        out[shape] = {name: fn(mesh, train) for name, fn in CASES.items()}
        out[shape]["_coords"] = (mesh_lib.data_coords(mesh),
                                 mesh_lib.model_coords(mesh))
        out[shape]["_clock"] = mesh_lib.shared_clock(lambda: float(rank),
                                                     mesh)()
    return out


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """``repro``'s reduced granite-8b train weights (numpy) and its
    jitted ``Generator``'s tokens on the reference's inputs."""
    import jax
    from repro import configs as jconfigs
    from repro.core import plan as jplan
    from repro.runtime import serve as jserve
    jp = jplan.PrecisionPlan.from_json(_plan().to_json())
    japi = jconfigs.get("granite-8b", reduced=True, policy=jp)
    jtrain = jconfigs.get("granite-8b", reduced=True).init_params(
        jax.random.PRNGKey(0), "train")
    np_train = jax.tree.map(lambda a: np.array(a), jtrain)
    gen = jserve.Generator(api=japi, params=jserve.pack_for_serving(
        japi, jtrain))
    return {"train": np_train,
            "tokens": gen.generate(_prompts(japi.cfg.vocab), NEW)}


@pytest.fixture(scope="module")
def meshed(reference, tmp_path_factory):
    store = tmp_path_factory.mktemp("world")
    return mesh_lib.spawn(_rank, WORLD, (reference["train"],),
                          store_dir=str(store), timeout_s=300)


@pytest.fixture(scope="module")
def single(reference):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train = convert.from_jax_lm_train_params(reference["train"],
                                                 device="cpu")
        return {name: fn(None, train) for name, fn in CASES.items()}
    finally:
        torch.set_num_threads(threads)


def _equal(a, b, path="") -> None:
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    else:
        assert a == b, path


def _shared(meshed, shape, name):
    """The case's results on ``shape``, bitwise the same on every rank
    (but its ``per_rank`` entry)."""
    def strip(r):
        return {k: v for k, v in meshed[r][shape][name].items()
                if k != "per_rank"}
    for r in range(1, WORLD):
        _equal(strip(0), strip(r), f"{shape} rank {r}")
    return strip(0)


# --- the contract ------------------------------------------------------------


def test_every_rank_has_its_coordinates(meshed):
    for shape in MESHES:
        d, m = shape
        got = [meshed[r][shape]["_coords"] for r in range(WORLD)]
        assert got == [((r // m, d), (r % m, m)) for r in range(WORLD)]


def test_every_rank_reads_rank_zeros_clock(meshed):
    """The schedulers' decisions must agree across 'model' too, or their
    collectives would not match: the shared clock spans the whole mesh."""
    for shape in MESHES:
        assert [meshed[r][shape]["_clock"] for r in range(WORLD)] == \
            [0.0] * WORLD


@pytest.mark.parametrize("shape", MESHES)
def test_tokens_equal_one_device_and_repro(meshed, single, reference, shape):
    got = _shared(meshed, shape, "lm")
    np.testing.assert_array_equal(got["tokens"], single["lm"]["tokens"])
    np.testing.assert_array_equal(got["tokens"], reference["tokens"])


@pytest.mark.parametrize("shape", MESHES)
def test_prefill_logits_bitwise_one_device(meshed, single, shape):
    got = _shared(meshed, shape, "lm")
    np.testing.assert_array_equal(got["logits"][0], single["lm"]["logits"][0])


@pytest.mark.parametrize("shape", MESHES)
def test_decode_logits_bitwise_one_device(meshed, single, shape):
    _equal(_shared(meshed, shape, "lm")["logits"][1:],
           single["lm"]["logits"][1:])


@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_its_slice(meshed, shape):
    """Head columns and o rows cut over 'model', the cache this rank's
    block of a length rounded up to the model axis, holding the prompt's
    positions that fall in it."""
    d, m = shape
    blocks = []
    for r in range(WORLD):
        pr = meshed[r][shape]["lm"]["per_rank"]
        assert pr["head_cols"] == 256 // m
        assert pr["o_rows"] == 64 // m // 2   # w8k4: 2 digits a byte
        assert pr["kv_seq"] == -(-13 // m)
        blocks.append(pr["prompt_block"])
    whole = np.concatenate(blocks[:m], axis=1)
    assert whole.shape[1] == -(-13 // m) * m
    assert not np.any(whole[:, 8:])        # prefill wrote 8 positions
    assert np.all(np.any(whole[:, :8] != 0, axis=0))


@pytest.mark.parametrize("shape", MESHES)
def test_packed_kv_cache(meshed, single, shape):
    got = _shared(meshed, shape, "kv")
    _equal(got, single["kv"])
    _equal(got["packed"], got["qdq"])


@pytest.mark.parametrize("shape", MESHES)
def test_speculative_generator(meshed, single, shape):
    _equal(_shared(meshed, shape, "specdec"), single["specdec"])


@pytest.mark.parametrize("shape", MESHES)
def test_generate_scheduler(meshed, single, shape):
    got = _shared(meshed, shape, "scheduler")
    _equal(got["results"], single["scheduler"]["alone"])
    _equal(got["alone"], single["scheduler"]["alone"])


def test_resnet_replicated_over_model(meshed, single):
    got = _shared(meshed, (2, 2), "resnet")
    np.testing.assert_array_equal(got["logits"], single["resnet"]["logits"])


# --- units ---------------------------------------------------------------------


@pytest.mark.parametrize("w_bits,k", FORMATS)
def test_acc_only_plain_twin_then_finish_is_fused(w_bits, k):
    gen = torch.Generator().manual_seed(w_bits * 8 + k)
    kdim, n, m = 147, 70, 9
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = torch.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                          generator=gen, dtype=torch.int32)
    planes = packing.pack_planes(w_int, fmt)
    a = torch.randint(-128, 128, (m, kdim), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    gamma = torch.rand((1, n), generator=gen) * 0.01
    colsum = w_int.sum(0, dtype=torch.int32).reshape(1, n)
    acc = kernel.mpmm_torch_acc(a, planes, fmt=fmt)
    assert acc.dtype == torch.int32
    assert torch.equal(acc, ops.mpmm_acc(a, planes, fmt=fmt))
    for out_dtype in (torch.float32, torch.bfloat16):
        got = epilogue.finish(acc, gamma, colsum, act_zero=128, spec=None,
                              out_dtype=out_dtype)
        assert torch.equal(got, kernel.mpmm_torch(
            a, planes, gamma, colsum, fmt=fmt, act_zero=128,
            out_dtype=out_dtype))


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("w_bits,k", [(8, 4), (4, 4), (2, 2), (1, 1)])
def test_k_sliced_accumulators_sum_to_whole(parts, w_bits, k):
    gen = torch.Generator().manual_seed(parts + w_bits)
    kdim, n = 256, 48
    fmt = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim)
    w_int = torch.randint(-(2 ** (w_bits - 1)), 2 ** (w_bits - 1), (kdim, n),
                          generator=gen, dtype=torch.int32)
    planes = packing.pack_planes(w_int, fmt)
    a = torch.randint(-128, 128, (5, kdim), generator=gen,
                      dtype=torch.int32).to(torch.int8)
    part = packing.PlaneFormat(w_bits=w_bits, k=k, k_dim=kdim // parts)
    kp = part.packed_k
    total = sum(ops.mpmm_acc(a[:, i * part.k_dim:(i + 1) * part.k_dim],
                             planes[:, i * kp:(i + 1) * kp], fmt=part)
                for i in range(parts))
    assert torch.equal(total, ops.mpmm_acc(a, planes, fmt=fmt))


def test_int32_sum_wraps_exactly():
    """The row shards' sum is int32 arithmetic: exact, wrap included."""
    big = torch.tensor([2 ** 31 - 1, -2 ** 31], dtype=torch.int32)
    one = torch.tensor([1, -1], dtype=torch.int32)
    assert torch.equal((big + one) - one, big)


@pytest.mark.parametrize("shape", MESHES)
def test_vocab_sharded_embedding_and_head(meshed, single, shape):
    got = _shared(meshed, shape, "embed_head")
    _equal(got, single["embed_head"])
    m = shape[1]
    for r in range(WORLD):
        pr = meshed[r][shape]["embed_head"]["per_rank"]
        assert pr["embed_rows"] * m == pr["whole_rows"] == 256


@pytest.mark.parametrize("shape", MESHES)
def test_split_decode_against_one_device(meshed, single, shape):
    """Every rank's split-sequence decode, at each query's valid length
    (10, 11, 12), bitwise the one-device routines: the bf16 cache against
    ``decode_attention``, the packed cache against
    ``decode_attention_streamed``."""
    from repro_torch.nn import kvcache
    ref = single["split_decode"]
    q, k, v = ref["q"], ref["k"], ref["v"]
    fmt = kvcache.KVFormat(4, 4, 16)
    kq, vq = kvcache.pack_kv(k, fmt), kvcache.pack_kv(v, fmt)
    want = {"bf16": torch.cat([A.decode_attention(q[:, t:t + 1], k, v,
                                                  10 + t)
                               for t in range(3)], dim=1),
            "packed": torch.cat([A.decode_attention_streamed(
                q[:, t:t + 1], kq, vq, fmt, fmt, 10 + t)
                for t in range(3)], dim=1)}
    for r in range(WORLD):
        got = meshed[r][shape]["split_decode"]
        lo, hi = got["per_rank"]["heads"]
        for key in ("bf16", "packed"):
            np.testing.assert_array_equal(
                got[key], want[key][:, :, lo:hi].float().numpy(),
                err_msg=f"{shape} rank {r} {key}")

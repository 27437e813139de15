"""Tensor-parallel serving of olmoe-1b-7b (expert parallelism),
deepseek-v2-lite-16b (MoE, MLA's sharded latent cache, the dense first
layer) and whisper-base (the cross cache) == one device.

As ``test_torch_tensor_parallel.py`` does for the dense decoders: ONE spawn
of four gloo ranks (``launch.mesh.spawn``) serves every case on a (2, 2)
and then a (1, 4) mesh, and the parent runs each case on one device.  The
reduced configs have 4 heads and 8 experts, so M = 4 leaves one head and
two experts a rank; whisper's 24 frames leave 6 a rank.  Each arch serves
under a plan of its own: olmoe's expert banks in two formats and a packed
kv4 cache, deepseek's dense prefix, shared experts and MLA projections in
three formats, whisper's stacks in three.  ``rng(3)`` prompts (4, 8) and 5
new tokens (whisper with ``rng(4)`` frames), so the cache length of 13 is
odd against the split.

Contract (README, "Tensor-parallel serving"): prefill and decode logits
bitwise the single-device port's; generated tokens equal the
single-device port's and ``repro``'s ``Generator`` on the same weights;
every rank holds the same logits; each rank holds its ``SERVE_RULES``
slice -- E/M experts of every bank, its heads' columns -- and its
``kv_seq`` block of the latent, self and cross caches.  The
``GenerateScheduler`` and ``SpeculativeGenerator`` over olmoe are held to
their single-device runs.  Unit tests: the router's column shards
gathered equal the whole ``router_logits`` (at the reduced width and at
olmoe's full width),
the expert-parallel combine is bitwise ``gate_and_combine`` on a
capacity-dropping case, the gathered-latent MLA decode is bitwise the
one-device ``mla_decode``, and whisper's cross split decode is bitwise
``decode_attention``.

The module imports no JAX at its top: the spawned ranks import it to find
the case functions.  ``repro``'s side runs once: its weights in a fixture
(jitted), its ``Generator`` jitted for olmoe and whisper and op by op for
deepseek (``_repro_tokens``), the last in a process of its own, started
first, beside the ranks' world.  Every rank computes on one thread, and
so does that process.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core.plan import KVCachePlan, LayerPlan, PrecisionPlan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as nnmoe
from repro_torch.runtime.scheduler import GenerateScheduler
from repro_torch.runtime.serve import (Generator, pack_for_serving,
                                       require_tensor_parallel)
from repro_torch.runtime.specdec import SpeculativeGenerator

WORLD = 4
MESHES = ((2, 2), (1, 4))
OLMOE, DEEPSEEK, WHISPER = ("olmoe-1b-7b", "deepseek-v2-lite-16b",
                            "whisper-base")
ARCHS = (OLMOE, DEEPSEEK, WHISPER)
PROMPTS, NEW = (4, 8), 5

PLAN_LAYERS = {
    OLMOE: {"l0.expert": (2, 2), "l1.expert": (8, 4), "q": (4, 4)},
    DEEPSEEK: {"l0.mlp": (2, 2), "shared": (8, 4), "uk": (4, 2),
               "o": (8, 1)},
    WHISPER: {"enc_qkvo": (8, 4), "dec_mlp": (2, 2), "dec_cross_kv": (4, 1)},
}


def _plan(arch, draft=False):
    """The arch's serving plan: mixed formats (olmoe channel-wise, with a
    packed kv4 cache); ``draft``: olmoe's uniform w2 draft with a kv2
    cache."""
    cw = arch == OLMOE
    if draft:
        return PrecisionPlan.build({}, default=LayerPlan(
            w_bits=2, k=2, channel_wise=cw), name="test_tp_draft",
            kv=KVCachePlan(bits=2, k=2, store="packed"))
    return PrecisionPlan.build(
        {n: LayerPlan(w_bits=w, k=k, channel_wise=cw)
         for n, (w, k) in PLAN_LAYERS[arch].items()},
        default=LayerPlan(w_bits=4, k=4, channel_wise=cw),
        name="test_tp_moe",
        kv=KVCachePlan(bits=4, k=4, store="packed") if arch == OLMOE
        else None)


def _api(arch, plan=None):
    return configs.get(arch, reduced=True, policy=plan or _plan(arch))


def _prompts(vocab):
    return np.asarray(np.random.default_rng(3).integers(
        0, vocab, PROMPTS), np.int32)


def _frames(api, b=PROMPTS[0]):
    """Whisper's stub frames (None for the other archs)."""
    if not api.needs_frames:
        return None
    return np.random.default_rng(4).normal(
        0, 1, (b, api.cfg.n_audio, api.cfg.d_model)).astype(np.float32)


def _numpy(tree):
    """A cache tree of tensors as numpy (float32), leaf for leaf."""
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.is_floating_point() \
            else tree.numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return [_numpy(v) for v in tree]


# --- the cases: each runs on ``mesh`` (None: one device) -> its results -----


def _slices(arch, params):
    """What this rank holds of the packed tree: bank experts, router and
    projection columns, row-shard rows."""
    if arch == WHISPER:
        enc, dec = params["enc_layers"][0], params["dec_layers"][0]
        return {"enc_q_cols": enc["attn"]["q"]["planes"].shape[-1],
                "enc_k_cols": enc["attn"]["k"]["planes"].shape[-1],
                "xq_cols": dec["xattn"]["q"]["planes"].shape[-1],
                "xo_rows": dec["xattn"]["o"]["planes"].shape[-2],
                "up_cols": dec["mlp"]["up"]["planes"].shape[-1],
                "head_cols": params["head"]["planes"].shape[-1]}
    out = {"banks": [[lp["moe"][key]["planes"].shape[0]
                      for key in ("gate", "up", "down")]
                     for lp in params["layers"] if "moe" in lp],
           "router_cols": [lp["moe"]["router"].shape[1]
                           for lp in params["layers"] if "moe" in lp],
           "q_cols": params["layers"][-1]["attn"]["q"]["planes"].shape[-1],
           "head_cols": params["head"]["planes"].shape[-1]}
    if arch == DEEPSEEK:
        a0, l1 = params["layers"][0], params["layers"][1]
        out.update(uk_cols=a0["attn"]["uk"]["planes"].shape[-1],
                   dkv_cols=a0["attn"]["dkv"]["planes"].shape[-1],
                   dense_up_cols=a0["mlp"]["up"]["planes"].shape[-1],
                   shared_gate_cols=l1["moe"]["shared_gate"]["planes"]
                   .shape[-1])
    return out


def case_lm(arch, mesh, trains):
    api = _api(arch)
    gen = Generator(api=api, params=pack_for_serving(api, trains[arch],
                                                     mesh=mesh),
                    device="cpu", mesh=mesh)
    prompts = _prompts(api.cfg.vocab)
    toks, logits = gen.run(prompts, NEW, frames=_frames(api))
    out = {"tokens": toks, "logits": [lg.float().numpy() for lg in logits]}
    # the first two prompts' prefill cache, grown to 13 positions
    batch = {"tokens": torch.as_tensor(prompts[:2], dtype=torch.long)}
    if api.needs_frames:
        batch["frames"] = torch.as_tensor(_frames(api, 2))
    pre = gen._prefill(gen.params, batch)[1]
    cache = _numpy(gen._grow_cache(pre, 2, 8, 13))
    out["cache0"] = ({"self": cache["self"][0], "cross": cache["cross"][0]}
                     if arch == WHISPER else cache[0])
    if mesh is not None:
        out["per_rank"] = dict(_slices(arch, gen.params),
                               data=mesh_lib.data_coords(mesh)[0],
                               model=mesh_lib.model_coords(mesh)[0])
    return out


def case_scheduler(mesh, trains):
    api = _api(OLMOE)
    gen = Generator(api=api, params=pack_for_serving(api, trains[OLMOE],
                                                     mesh=mesh),
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


def case_specdec(mesh, trains):
    verify, draft = _plan(OLMOE), _plan(OLMOE, draft=True)
    api = _api(OLMOE, verify)
    views = tuple(pack_for_serving(dataclasses.replace(api, policy=p),
                                   trains[OLMOE], mesh=mesh)
                  for p in (verify, draft))
    sg = SpeculativeGenerator(api=api, packed_views=views, draft_plan=draft,
                              k=3, device="cpu", mesh=mesh)
    toks = sg.generate(_prompts(api.cfg.vocab)[:3, :6], 7)
    return {"tokens": toks, "drafted": sg.drafted_tokens,
            "accepted": sg.accepted_tokens}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tp(mesh):
    return None if mesh is None or mesh_lib.model_coords(mesh)[1] == 1 \
        else mesh


def _model_cols(mesh, n):
    """This rank's block of ``n`` columns over 'model' (all of them
    without a mesh)."""
    r, m = mesh_lib.model_coords(mesh) if mesh is not None else (0, 1)
    return slice(r * n // m, (r + 1) * n // m)


def case_router(mesh, trains):
    """``router_logits`` of a rank's column shard, gathered, at the
    reduced width and at olmoe's full width (2048 x 64, 4 x 256 tokens)."""
    del trains
    out = {}
    for name, (b, s, d, e) in (("reduced", (3, 5, 64, 8)),
                               ("full", (4, 256, 2048, 64))):
        g = torch.Generator().manual_seed(d)
        x = torch.randn(b, s, d, generator=g).to(torch.bfloat16)
        router = torch.randn(d, e, generator=g)
        out[name] = nnmoe.router_logits(
            x, router[:, _model_cols(_tp(mesh), e)].contiguous(),
            _tp(mesh)).numpy()
    return out


COMBINE = nnmoe.MoEConfig(d_model=16, d_ff=8, n_experts=8, topk=3,
                          capacity_factor=0.75)


def _combine_inputs():
    """Routing and expert outputs of 2 rows of 12 tokens at capacity 3,
    where 36 choices a row for 24 slots drop some; one expert row NaN."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 12, 16, generator=g).to(torch.bfloat16)
    idx, vals, tok_idx = nnmoe.route(x, torch.randn(16, 8, generator=g),
                                     COMBINE)
    h = torch.randn(2, 8, tok_idx.shape[-1], 16, generator=g).to(
        torch.bfloat16)
    h[1, 5, 0, 3] = float("nan")
    return idx, vals, tok_idx, h


def case_combine(mesh, trains):
    del trains
    idx, vals, tok_idx, h = _combine_inputs()
    if _tp(mesh) is None:
        return {"y": nnmoe.gate_and_combine(h, vals, tok_idx, idx, 12,
                                            serve=True).numpy()}
    return {"y": nnmoe.expert_parallel_combine(
        h[:, _model_cols(mesh, 8)], vals, tok_idx, idx, 12, mesh).numpy()}


def _latent_inputs(cfg):
    g = torch.Generator().manual_seed(21)
    m = cfg.mla
    x = torch.randn(2, 1, cfg.d_model, generator=g).to(torch.bfloat16)
    c = torch.randn(2, 16, m.kv_lora, generator=g).to(torch.bfloat16)
    kr = torch.randn(2, 16, m.qk_rope, generator=g).to(torch.bfloat16)
    return x, c, kr


def case_mla_decode(mesh, trains):
    """``mla_decode`` of deepseek's layer 1 at position 9 of a 16-position
    latent cache: this rank's block written in place, the latent gathered,
    the rank's heads over the whole sequence."""
    api = _api(DEEPSEEK)
    cfg = api.cfg
    params = pack_for_serving(api, trains[DEEPSEEK], mesh=mesh)
    x, c, kr = _latent_inputs(cfg)
    tp = _tp(mesh)
    blk = _model_cols(tp, 16)
    cache = (c[:, blk].clone(), kr[:, blk].clone())
    sin, cos = L.rotary_cache(torch.full((2, 1), 9), cfg.rope_dim,
                              cfg.rope_base)
    out, cache = A.mla_decode(params["layers"][1]["attn"], x, cache, 9,
                              api.policy, sin=sin, cos=cos, mesh=tp,
                              **T._mla_kw(cfg))
    return {"out": out.float().numpy(),
            "per_rank": {"c_block": cache[0].float().numpy(),
                         "kr_block": cache[1].float().numpy(),
                         "model": mesh_lib.model_coords(mesh)[0]
                         if mesh is not None else 0,
                         "blk": (blk.start, blk.stop)}}


def case_cross_decode(mesh, trains):
    """whisper's decode-step cross attention over this rank's block of the
    24 frames, its heads."""
    del trains
    g = torch.Generator().manual_seed(31)
    q = torch.randn(2, 1, 4, 16, generator=g).to(torch.bfloat16)
    ck = torch.randn(2, 24, 4, 16, generator=g).to(torch.bfloat16)
    cv = torch.randn(2, 24, 4, 16, generator=g).to(torch.bfloat16)
    tp = _tp(mesh)
    if tp is None:
        return {"q": q, "ck": ck, "cv": cv}
    heads, blk = _model_cols(tp, 4), _model_cols(tp, 24)
    return {"o": W.cross_decode(q[:, :, heads], ck[:, blk].contiguous(),
                                cv[:, blk].contiguous(), 24, tp)
            .float().numpy(),
            "heads": (heads.start, heads.stop)}


CASES = {f"lm_{a}": (lambda mesh, trains, a=a: case_lm(a, mesh, trains))
         for a in ARCHS}
CASES.update({f.__name__[5:]: f for f in (
    case_scheduler, case_specdec, case_router, case_combine,
    case_mla_decode, case_cross_decode)})


def _trains(np_trains):
    return {a: convert.from_jax_lm_train_params(t, device="cpu")
            for a, t in np_trains.items()}


def _repro_weights(arch):
    """``repro``'s reduced train weights of ``arch`` (its jitted init at
    key 0), as numpy."""
    import jax
    from repro import configs as jconfigs
    api = jconfigs.get(arch, reduced=True)
    tree = jax.jit(lambda k: api.init_params(k, "train"))(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.array(a), tree)


def _digest(tree) -> str:
    """sha256 of a nested dict / list of arrays, leaf by leaf in order."""
    import hashlib
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                h.update(str(k).encode())
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            a = np.asarray(t)
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
    walk(tree)
    return h.hexdigest()


def _repro_tokens(arch, np_train):
    """``repro``'s ``Generator`` tokens for ``arch`` on the same weights,
    inputs and plan.  Deepseek's run goes op by op (``jax.disable_jit``:
    its jitted run fuses differently and flips a near-tie at this size;
    the port is held to the op-by-op run, as in
    ``test_torch_lm_families``); olmoe's and whisper's jitted runs give
    the op-by-op tokens at this size, at an eighth of the time."""
    import contextlib

    import jax
    from repro import configs as jconfigs
    from repro.core import plan as jplan
    from repro.runtime import serve as jserve
    jp = jplan.PrecisionPlan.from_json(_plan(arch).to_json())
    japi = jconfigs.get(arch, reduced=True, policy=jp)
    jtrain = jax.tree.map(jax.numpy.asarray, np_train)
    gen = jserve.Generator(api=japi, params=jax.jit(
        lambda t: jserve.pack_for_serving(japi, t))(jtrain))
    kw = {"frames": _frames(japi)} if japi.needs_frames else {}
    with (jax.disable_jit() if arch == DEEPSEEK
          else contextlib.nullcontext()):
        return gen.generate(_prompts(japi.cfg.vocab), NEW, **kw)


def _repro_alone(arch):
    """``_repro_tokens`` of ``arch`` in a process of its own, on weights
    made there, XLA on one thread -> (the weights' ``_digest``, tokens)."""
    import os
    os.environ["XLA_FLAGS"] = " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_cpu_multi_thread_eigen=false",
        "intra_op_parallelism_threads=1")))
    train = _repro_weights(arch)
    return _digest(train), _repro_tokens(arch, train)


def _rank(rank, np_trains):
    """One rank: every case on each of ``MESHES`` -> {shape: {case:
    results}}."""
    torch.set_num_threads(1)
    trains = _trains(np_trains)
    out = {}
    for shape in MESHES:
        mesh = mesh_lib.make_serve_mesh(*shape, device="cpu")
        out[shape] = {name: fn(mesh, trains) for name, fn in CASES.items()}
    return out


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def repro_deepseek():
    """``_repro_alone(DEEPSEEK)`` started first, in a process of its own
    that runs beside the parent's work and the ranks' world: its op-by-op
    run is the module's longest piece."""
    import torch.multiprocessing as mp
    pool = mp.get_context("spawn").Pool(1)
    try:
        yield pool.apply_async(_repro_alone, (DEEPSEEK,))
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module")
def weights():
    """``repro``'s reduced train weights of the three archs, as numpy."""
    return {arch: _repro_weights(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def meshed(repro_deepseek, weights, tmp_path_factory):
    store = tmp_path_factory.mktemp("world")
    return mesh_lib.spawn(_rank, WORLD, (weights,), store_dir=str(store),
                          timeout_s=400)


@pytest.fixture(scope="module")
def reference(repro_deepseek, weights):
    """{arch: ``repro``'s tokens}: olmoe's and whisper's here, deepseek's
    from its own process, on the same weights (their digests equal)."""
    out = {a: _repro_tokens(a, weights[a]) for a in (OLMOE, WHISPER)}
    digest, out[DEEPSEEK] = repro_deepseek.get(timeout=400)
    assert digest == _digest(weights[DEEPSEEK])
    return out


@pytest.fixture(scope="module")
def single(weights):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trains = _trains(weights)
        return {name: fn(None, trains) for name, fn in CASES.items()}
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


def _shared(meshed, shape, name, skip=("per_rank", "cache0")):
    """The case's results on ``shape``, bitwise the same on every rank
    (but its rank-local entries)."""
    def strip(r):
        return {k: v for k, v in meshed[r][shape][name].items()
                if k not in skip}
    for r in range(1, WORLD):
        _equal(strip(0), strip(r), f"{shape} rank {r}")
    return strip(0)


# --- the contract ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_tokens_equal_one_device_and_repro(meshed, single, reference, shape,
                                           arch):
    got = _shared(meshed, shape, f"lm_{arch}")
    np.testing.assert_array_equal(got["tokens"], single[f"lm_{arch}"]
                                  ["tokens"])
    np.testing.assert_array_equal(got["tokens"], reference[arch])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_logits_bitwise_one_device(meshed, single, shape, arch):
    got = _shared(meshed, shape, f"lm_{arch}")
    np.testing.assert_array_equal(got["logits"][0],
                                  single[f"lm_{arch}"]["logits"][0])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_decode_logits_bitwise_one_device(meshed, single, shape, arch):
    _equal(_shared(meshed, shape, f"lm_{arch}")["logits"][1:],
           single[f"lm_{arch}"]["logits"][1:])


def _want_slices(arch, m):
    cfg = _api(arch).cfg
    if arch == WHISPER:
        return {"enc_q_cols": 64 // m, "enc_k_cols": 64, "xq_cols": 64 // m,
                "xo_rows": 64 // m // 2,          # w4k4: 2 digits a byte
                "up_cols": cfg.d_ff // m, "head_cols": 256 // m}
    e = cfg.moe.n_experts // m
    n_moe = cfg.n_layers - cfg.dense_first_n
    out = {"banks": [[e] * 3] * n_moe, "router_cols": [e] * n_moe,
           "head_cols": 256 // m}
    if arch == OLMOE:
        out["q_cols"] = 64 // m
    else:
        mla = cfg.mla
        out.update(q_cols=4 * (mla.qk_nope + mla.qk_rope) // m,
                   uk_cols=4 * mla.qk_nope // m,
                   dkv_cols=mla.kv_lora + mla.qk_rope,
                   dense_up_cols=cfg.dense_ff // m,
                   shared_gate_cols=cfg.moe.shared_hidden // m)
    return out


def _blocks(meshed, shape, name, key):
    """The 'model' ranks' cache blocks of each data coordinate,
    concatenated along the sequence axis in rank order -> {data coordinate:
    whole tree}."""
    def cat(parts):
        if isinstance(parts[0], dict):
            return {k: cat([p[k] for p in parts]) for k in parts[0]}
        if isinstance(parts[0], (list, tuple)):
            return [cat([p[i] for p in parts]) for i in range(len(parts[0]))]
        return parts
    out = {}
    for r in range(WORLD):
        res = meshed[r][shape][name]
        out.setdefault(res["per_rank"]["data"], []).append(res[key])
    return {d: cat(parts) for d, parts in out.items()}


def _seq_axis(path):
    return 2 if path.endswith(".p") else 1


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_its_slice(meshed, single, shape, arch):
    """Each rank: E/M experts of every bank and E/M router columns, its
    heads' columns of q (MLA's q and uk, whisper's q of both attentions),
    its heads' rows of o, the dense prefix's and shared experts' columns,
    k/v and dkv whole; and its ``kv_seq`` block of every cache (olmoe's
    packed K/V, MLA's latent pair, whisper's self cache and its 24 cross
    frames), which, concatenated over 'model' in rank order, is the
    single-device cache of its data coordinate's rows."""
    d, m = shape
    name = f"lm_{arch}"
    for r in range(WORLD):
        pr = meshed[r][shape][name]["per_rank"]
        got = {k: v for k, v in pr.items() if k not in ("data", "model")}
        assert got == _want_slices(arch, m), (shape, r)
        assert (pr["data"], pr["model"]) == (r // m, r % m)
    whole = single[name]["cache0"]
    rows = 2 // d
    for dc, parts in _blocks(meshed, shape, name, "cache0").items():
        def check(want, got, path=""):
            if isinstance(want, dict):
                for k in want:
                    check(want[k], got[k], f"{path}.{k}")
            elif isinstance(want, (list, tuple)):
                for i, w in enumerate(want):
                    check(w, got[i], f"{path}[{i}]")
            else:
                ax = _seq_axis(path)
                sl = [slice(None)] * want.ndim
                sl[ax - 1] = slice(dc * rows, (dc + 1) * rows)  # batch
                w = want[tuple(sl)]
                g = np.concatenate(got, axis=ax)
                assert g.shape[ax] == -(-w.shape[ax] // m) * m, path
                np.testing.assert_array_equal(
                    g.take(range(w.shape[ax]), axis=ax), w, err_msg=path)
                assert not np.any(g.take(range(w.shape[ax], g.shape[ax]),
                                         axis=ax)), path
        check(whole, parts)


@pytest.mark.parametrize("shape", MESHES)
def test_generate_scheduler_over_olmoe(meshed, single, shape):
    got = _shared(meshed, shape, "scheduler")
    _equal(got["results"], single["scheduler"]["alone"])
    _equal(got["alone"], single["scheduler"]["alone"])


@pytest.mark.parametrize("shape", MESHES)
def test_speculative_generator_over_olmoe(meshed, single, shape):
    _equal(_shared(meshed, shape, "specdec"), single["specdec"])


# --- units -----------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_router_column_shards_gather_to_the_whole(meshed, single, shape):
    """Every rank's gathered router scores are the whole product's, bitwise
    (the single-device case multiplies the whole router), at olmoe's full
    width too, where a 16-column shard's own product differs on the
    CPU."""
    _equal(_shared(meshed, shape, "router"), single["router"])


@pytest.mark.parametrize("shape", MESHES)
def test_expert_parallel_combine_bitwise(meshed, single, shape):
    """The gathered combine on a case whose capacity drops tokens (and one
    NaN expert row) is bitwise the one-device ``gate_and_combine``."""
    idx, vals, tok_idx, _ = _combine_inputs()
    routed = torch.zeros((2, 12, 8), dtype=torch.bool).scatter_(2, idx, True)
    took = torch.zeros_like(routed)
    took.scatter_(1, tok_idx.transpose(1, 2), True)
    assert bool((routed & ~took).any())   # a capacity drop
    _equal(_shared(meshed, shape, "combine"), single["combine"])
    assert np.isnan(single["combine"]["y"]).any()


@pytest.mark.parametrize("shape", MESHES)
def test_gathered_latent_mla_decode_bitwise(meshed, single, shape):
    """Each rank's output is the one-device ``mla_decode``'s, bitwise, and
    position 9 was written into the block of its owner only."""
    _equal(_shared(meshed, shape, "mla_decode"),
           {"out": single["mla_decode"]["out"]})
    want = single["mla_decode"]["per_rank"]
    for r in range(WORLD):
        pr = meshed[r][shape]["mla_decode"]["per_rank"]
        lo, hi = pr["blk"]
        np.testing.assert_array_equal(pr["c_block"],
                                      want["c_block"][:, lo:hi])
        np.testing.assert_array_equal(pr["kr_block"],
                                      want["kr_block"][:, lo:hi])


@pytest.mark.parametrize("shape", MESHES)
def test_whisper_cross_split_decode_bitwise(meshed, single, shape):
    ref = single["cross_decode"]
    want = A.decode_attention(ref["q"], ref["ck"], ref["cv"], 24)
    for r in range(WORLD):
        got = meshed[r][shape]["cross_decode"]
        lo, hi = got["heads"]
        np.testing.assert_array_equal(
            got["o"], want[:, :, lo:hi].float().numpy(),
            err_msg=f"{shape} rank {r}")


# --- entry points ------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_accept_the_three(arch):
    """``require_tensor_parallel`` and ``launch.serve``'s mesh check pass
    the three archs at M = 2 and 4."""
    api = configs.get(arch, reduced=True)
    for m in (2, 4):
        require_tensor_parallel(api, {"data": 1, "model": m})
        args = launch_serve._parser().parse_args(
            ["--arch", arch, "--reduced", "--device", "cpu", "--mesh",
             f"1x{m}"])
        assert launch_serve._world(args) == (m, m, True)


@pytest.mark.parametrize("arch,policy", [
    ("mamba2-1.3b", None), ("recurrentgemma-9b", None),
    ("granite-8b", "fp")])
def test_what_is_left_of_16b_ii_b_is_refused(arch, policy):
    """What was left of 16b (ii-b) -- mamba2, recurrentgemma and the fp
    baseline -- serves at M = 2 now (``test_torch_tensor_parallel_ssm``)
    and is refused only where its heads do not split (M = 3)."""
    from repro_torch.core.precision import PrecisionPolicy
    pol = PrecisionPolicy(quantize=False) if policy == "fp" else None
    api = configs.get(arch, reduced=True, policy=pol)
    require_tensor_parallel(api, {"data": 1, "model": 2})
    with pytest.raises(ValueError, match="heads do not split evenly .* "
                                         "of 3"):
        require_tensor_parallel(api, {"data": 1, "model": 3})


@pytest.mark.parametrize("what,m", [("heads", 3), ("experts", 4),
                                    ("n_audio frames", 4)])
def test_uneven_split_names_both_numbers(what, m):
    api = configs.get(WHISPER if what == "n_audio frames" else OLMOE,
                      reduced=True)
    cfg = api.cfg
    if what == "experts":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=6))
        n = 6
    elif what == "n_audio frames":
        cfg = dataclasses.replace(cfg, n_audio=22)
        n = 22
    else:
        n = cfg.n_heads
    api = dataclasses.replace(api, cfg=cfg)
    with pytest.raises(ValueError, match=f"{n} {what} .* of {m}"):
        require_tensor_parallel(api, {"data": 1, "model": m})


def test_whisper_serves_over_two_ranks_from_the_cli(capfd):
    """``launch.serve --arch whisper-base --devices 2 --mesh 1x2`` (zero
    stub frames) prints the single-device run's greedy sample."""
    argv = ["--arch", WHISPER, "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "5", "--new-tokens", "3"]
    samples = []
    for extra in ([], ["--devices", "2", "--mesh", "1x2"]):
        assert launch_serve.main(argv + extra) == 0
        samples.append([ln for ln in capfd.readouterr().out.splitlines()
                        if "sample:" in ln])
    assert len(samples[0]) == 1
    assert samples[0] == samples[1]

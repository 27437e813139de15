"""Tensor-parallel serving of mamba2-1.3b (the SSD block's heads),
recurrentgemma-9b (the RG-LRU's channels, the local attention's ring) and
the fp baseline (``quantize=False``) == one device.

As ``test_torch_tensor_parallel_moe.py`` does for olmoe, deepseek and
whisper: ONE spawn of four gloo ranks (``launch.mesh.spawn``) serves every
case on a (2, 2) and then a (1, 4) mesh, and the parent runs each case on
one device.  The reduced mamba2 has 8 SSD heads, the reduced
recurrentgemma 4 attention heads over a window of 8, so M = 4 leaves two
SSD heads, one attention head and 16 RG-LRU channels a rank.  ``rng(3)``
prompts (4, 13) and 5 new tokens: the cache length of 18 is odd against
the split, and recurrentgemma's 8-slot ring wraps in the prefill and
again in decode.  The fp cases serve the reduced granite-8b, olmoe-1b-7b
(its banks by whole experts) and mamba2 under ``PrecisionPolicy(quantize=
False)``.

Contract (README, "Tensor-parallel serving"): prefill and decode logits
bitwise the single-device port's; generated tokens equal the
single-device port's and ``repro``'s ``Generator`` on the same weights
(mamba2 at S = ``chunk``, where the reference's state is right, ROADMAP
Queue 3 R6, as ``test_torch_ssm.py`` holds it; the rest at S 13); every
rank holds the same logits; each rank holds only its slice of the weights
and of the decode state.  The ``GenerateScheduler`` over recurrentgemma is
held to its single-device run.  Unit tests, each bitwise: the ``in_xbc``
column pieces against the whole layer's columns; the RG-LRU's ``w_a`` and
``w_x`` as row shards against the whole product; the ring's split decode
against ``decode_attention`` on a wrapped ring; the fp column shard at the
padded shape against the whole product's columns.

The module imports no JAX at its top: the spawned ranks import it to find
the case functions.  ``repro``'s side runs once, in module-scoped
fixtures: its weights and its jitted ``Generator`` runs in the parent, its
op-by-op runs (``OP_BY_OP``, the file's longest pieces) in two processes
of their own started first, and the ranks' world in a thread of the
parent meanwhile.  Every rank computes on one thread, and so do those
processes.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import attention as A
from repro_torch.nn import quantized as Q
from repro_torch.nn import ssm as nnssm
from repro_torch.nn.layers import pad_vocab
from repro_torch.runtime.scheduler import GenerateScheduler
from repro_torch.runtime.serve import (Generator, local_params,
                                       pack_for_serving,
                                       require_tensor_parallel)

WORLD = 4
MESHES = ((2, 2), (1, 4))
MAMBA, RG, GRANITE, OLMOE = ("mamba2-1.3b", "recurrentgemma-9b",
                             "granite-8b", "olmoe-1b-7b")
ARCHS = (MAMBA, RG, GRANITE, OLMOE)
FP = PrecisionPolicy(quantize=False)
# case -> (arch, fp baseline?)
LM = {"mamba2": (MAMBA, False), "rg": (RG, False),
      "fp_granite": (GRANITE, True), "fp_olmoe": (OLMOE, True),
      "fp_mamba2": (MAMBA, True)}
PROMPTS, NEW = (4, 13), 5
OP_BY_OP = ("rg", "fp_mamba2")  # repro's Generator without jit (_repro_tokens)


def _api(case):
    arch, fp = LM[case]
    return configs.get(arch, reduced=True, policy=FP if fp else None)


def _prompts(vocab, s=PROMPTS[1]):
    return np.asarray(np.random.default_rng(3).integers(
        0, vocab, (PROMPTS[0], s)), np.int32)


def _chunk_len(case):
    """The prompt length ``repro``'s tokens are held at: mamba2's chunk
    (R6), else the odd S."""
    api = _api(case)
    return api.cfg.ssm.chunk if api.family == "ssm" else PROMPTS[1]


def _numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy() if tree.is_floating_point() \
            else tree.numpy()
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return [_numpy(v) for v in tree]


def _cols(p):
    """A serve layer's output columns and its (packed) rows."""
    w = p["w"] if "w" in p else p["planes"]
    return int(w.shape[-1]), int(w.shape[-2])


# --- the cases: each runs on ``mesh`` (None: one device) -> its results -----


def _slices(case, params):
    """What this rank holds of the tree: (columns, rows) of the
    projections, the conv's channels, per-head vectors, the embedding's
    rows."""
    api = _api(case)
    lp = params["layers"][0]
    out = {"head": _cols(params["head"]),
           "embed_rows": int(next(iter(params["embed"].values())).shape[0])}
    if api.family == "ssm":
        blk = lp["ssm"]
        out.update({k: _cols(blk[k]) for k in ("in_xbc", "in_z", "in_dt",
                                               "out")},
                   conv=tuple(blk["conv"]["w"].shape),
                   a_log=int(blk["A_log"].shape[0]))
    elif api.family == "hybrid":
        rnn, att = lp["rnn"], params["layers"][2]["attn"]
        out.update({k: _cols(rnn[k]) for k in ("in_x", "w_a", "w_x",
                                               "out")},
                   w_a_gamma=int(rnn["w_a"]["gamma"].shape[-1]),
                   conv=tuple(rnn["conv"]["w"].shape),
                   lam=int(rnn["lam"].shape[0]),
                   q=_cols(att["q"]), k=_cols(att["k"]), o=_cols(att["o"]),
                   gate=_cols(lp["mlp"]["gate"]),
                   down=_cols(lp["mlp"]["down"]))
    else:
        out.update(q=_cols(lp["attn"]["q"]), k=_cols(lp["attn"]["k"]),
                   o=_cols(lp["attn"]["o"]))
        if "moe" in lp:
            out["bank"] = tuple(lp["moe"]["up"]["w"].shape)
        else:
            out.update(up=_cols(lp["mlp"]["up"]),
                       down=_cols(lp["mlp"]["down"]))
    return out


def case_lm(case, mesh, trains):
    api = _api(case)
    arch = LM[case][0]
    gen = Generator(api=api, params=pack_for_serving(api, trains[arch],
                                                     mesh=mesh),
                    device="cpu", mesh=mesh)
    prompts = _prompts(api.cfg.vocab)
    toks, logits = gen.run(prompts, NEW)
    out = {"tokens": toks, "logits": [lg.float().numpy() for lg in logits]}
    if _chunk_len(case) != PROMPTS[1]:
        out["tokens_chunk"] = gen.generate(
            _prompts(api.cfg.vocab, _chunk_len(case)), NEW)
    # the first two prompts' decode cache, grown to 18 positions
    batch = {"tokens": torch.as_tensor(prompts[:2], dtype=torch.long)}
    pre = gen._prefill(gen.params, batch)[1]
    cache = _numpy(gen._grow_cache(pre, 2, PROMPTS[1], PROMPTS[1] + NEW))
    out["cache"] = ({"r0": cache[0], "a2": cache[2]}
                    if api.family == "hybrid" else {"l0": cache[0]})
    if mesh is not None:
        out["per_rank"] = dict(slices=_slices(case, gen.params),
                               data=mesh_lib.data_coords(mesh)[0],
                               model=mesh_lib.model_coords(mesh)[0])
    return out


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


SCHED = ((6, 3), (6, 5), (4, 2), (6, 4))  # (prompt tokens, new tokens)


def case_scheduler(mesh, trains):
    api = _api("rg")
    gen = Generator(api=api, params=pack_for_serving(api, trains[RG],
                                                     mesh=mesh),
                    device="cpu", mesh=mesh)
    sched = GenerateScheduler(gen, slots=4, max_len=15, clock=FakeClock())
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, api.cfg.vocab, (n,)).astype(np.int32)
               for n, _ in SCHED]
    tickets = [sched.submit(p, n) for p, (_, n) in zip(prompts, SCHED)]
    sched.run_until_idle()
    return {"results": [t.result for t in tickets],
            "alone": [gen.generate(p.reshape(1, -1), n)[0]
                      for p, (_, n) in zip(prompts, SCHED)]}


def _tp(mesh):
    return None if mesh is None or mesh_lib.model_coords(mesh)[1] == 1 \
        else mesh


def _block(mesh, n):
    """This rank's block of ``n`` over 'model' (all of it without a
    tensor-parallel mesh)."""
    r, m = mesh_lib.model_coords(mesh) if mesh is not None else (0, 1)
    return slice(r * n // m, (r + 1) * n // m)


def _gate_inputs(d_rnn):
    g = torch.Generator().manual_seed(41)
    return torch.randn(2, 5, d_rnn, generator=g).to(torch.bfloat16)


def case_gates(mesh, trains):
    """``w_a`` and ``w_x`` of recurrentgemma's layer 0 as this rank's row
    shards (quantized and the fp baseline) on its channels of one input
    -> the rank's channels of each gate."""
    out = {}
    for tag, pol in (("packed", None), ("fp", FP)):
        api = configs.get(RG, reduced=True, policy=pol)
        rnn = local_params(api, pack_for_serving(api, trains[RG]),
                           _tp(mesh))["layers"][0]["rnn"]
        x = _gate_inputs(api.cfg.rnn.d_rnn)
        blk = _block(_tp(mesh), x.shape[-1])
        for key in ("w_a", "w_x"):
            out[f"{tag}_{key}"] = Q.qlinear_serve_apply(
                rnn[key], x[..., blk], api.policy, name="rnn_gates",
                row_mesh=_tp(mesh)).float().numpy()
        out[f"{tag}_blk"] = (blk.start, blk.stop)
    return out


def _ring_inputs():
    g = torch.Generator().manual_seed(51)
    q = torch.randn(2, 1, 4, 16, generator=g).to(torch.bfloat16)
    ck = torch.randn(2, 8, 1, 16, generator=g).to(torch.bfloat16)
    cv = torch.randn(2, 8, 1, 16, generator=g).to(torch.bfloat16)
    return q, ck, cv


def case_ring(mesh, trains):
    """The ring's split decode over this rank's heads and slots, wrapped
    (all 8 slots valid) and not (5)."""
    del trains
    q, ck, cv = _ring_inputs()
    tp = _tp(mesh)
    heads, slots = _block(tp, 4), _block(tp, 8)
    out = {}
    for n in (8, 5):
        out[f"o{n}"] = A.ring_decode_attention(
            q[:, :, heads], ck[:, slots].contiguous(),
            cv[:, slots].contiguous(), n, tp).float().numpy()
    out["heads"] = (heads.start, heads.stop)
    return out


CASES = {f"lm_{c}": (lambda mesh, trains, c=c: case_lm(c, mesh, trains))
         for c in LM}
CASES.update({f.__name__[5:]: f for f in (case_scheduler, case_gates,
                                          case_ring)})


def _trains(np_trains):
    return {a: convert.from_jax_lm_train_params(t, device="cpu")
            for a, t in np_trains.items()}


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


# --- repro's side -----------------------------------------------------------


def _repro_weights(arch):
    """``repro``'s reduced train weights of ``arch`` (its jitted init at
    key 0), as numpy."""
    import jax
    from repro import configs as jconfigs
    api = jconfigs.get(arch, reduced=True)
    tree = jax.jit(lambda k: api.init_params(k, "train"))(
        jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: np.array(a), tree)


def _repro_tokens(case, np_train):
    """``repro``'s ``Generator`` tokens for ``case`` on the same weights
    and prompts (mamba2's at S = chunk), its pack jitted.  recurrentgemma
    and the fp mamba2 serve op by op (``jax.disable_jit``: their jitted
    runs fuse differently and flip a near-tie of one prompt at this size
    -- the fp mamba2's is an exact tie of two bf16 logits; the port is
    held to the op-by-op run, as in ``test_torch_rglru``); the others'
    jitted runs give the op-by-op tokens here."""
    import contextlib

    import jax
    from repro import configs as jconfigs
    from repro.core.precision import PrecisionPolicy as JPolicy
    from repro.runtime import serve as jserve
    arch, fp = LM[case]
    japi = jconfigs.get(arch, reduced=True,
                        policy=JPolicy(quantize=False) if fp else None)
    jtrain = jax.tree.map(jax.numpy.asarray, np_train)
    gen = jserve.Generator(api=japi, params=jax.jit(
        lambda t: jserve.pack_for_serving(japi, t))(jtrain))
    with (jax.disable_jit() if case in OP_BY_OP
          else contextlib.nullcontext()):
        return gen.generate(_prompts(japi.cfg.vocab, _chunk_len(case)),
                            NEW)


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


def _repro_alone(case):
    """``_repro_tokens`` of ``case`` in a process of its own, on weights
    made there, XLA on one thread -> (the weights' ``_digest``, tokens)."""
    import os
    os.environ["XLA_FLAGS"] = " ".join(filter(None, (
        os.environ.get("XLA_FLAGS"), "--xla_cpu_multi_thread_eigen=false",
        "intra_op_parallelism_threads=1")))
    train = _repro_weights(LM[case][0])
    return _digest(train), _repro_tokens(case, train)


# --- fixtures ----------------------------------------------------------------


@pytest.fixture(scope="module")
def repro_op_by_op():
    """``_repro_alone`` of each ``OP_BY_OP`` case, started first in a
    process of its own beside the parent's work and the ranks' world."""
    import torch.multiprocessing as mp
    pool = mp.get_context("spawn").Pool(len(OP_BY_OP))
    try:
        yield {c: pool.apply_async(_repro_alone, (c,)) for c in OP_BY_OP}
    finally:
        pool.terminate()
        pool.join()


@pytest.fixture(scope="module")
def weights(repro_op_by_op):
    """``repro``'s reduced train weights of the four archs, as numpy."""
    return {arch: _repro_weights(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """The ranks' world, served from a thread of the parent: a future of
    ``_rank``'s results."""
    import concurrent.futures
    store = tmp_path_factory.mktemp("world")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        yield pool.submit(mesh_lib.spawn, _rank, WORLD, (weights,),
                          store_dir=str(store), timeout_s=400)
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def meshed(world, single, reference):
    """Every rank's results, once the parent's own fixtures are done."""
    return world.result(timeout=400)


@pytest.fixture(scope="module")
def reference(world, weights, repro_op_by_op):
    """{case: ``repro``'s tokens}: the jitted runs here, the op-by-op ones
    from their own processes, on the same weights (their digests
    equal)."""
    out = {c: _repro_tokens(c, weights[LM[c][0]]) for c in LM
           if c not in OP_BY_OP}
    for c, job in repro_op_by_op.items():
        digest, out[c] = job.get(timeout=400)
        assert digest == _digest(weights[LM[c][0]])
    return out


@pytest.fixture(scope="module")
def single(world, weights):
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


def _shared(meshed, shape, name, skip=("per_rank", "cache")):
    """The case's results on ``shape``, bitwise the same on every rank
    (but its rank-local entries)."""
    def strip(r):
        return {k: v for k, v in meshed[r][shape][name].items()
                if k not in skip}
    for r in range(1, WORLD):
        _equal(strip(0), strip(r), f"{shape} rank {r}")
    return strip(0)


# --- the contract ------------------------------------------------------------


@pytest.mark.parametrize("case", list(LM))
@pytest.mark.parametrize("shape", MESHES)
def test_tokens_equal_one_device_and_repro(meshed, single, reference, shape,
                                           case):
    got = _shared(meshed, shape, f"lm_{case}")
    want = single[f"lm_{case}"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    key = "tokens_chunk" if "tokens_chunk" in want else "tokens"
    np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(want[key], reference[case])


@pytest.mark.parametrize("case", list(LM))
@pytest.mark.parametrize("shape", MESHES)
def test_prefill_logits_bitwise_one_device(meshed, single, shape, case):
    got = _shared(meshed, shape, f"lm_{case}")
    np.testing.assert_array_equal(got["logits"][0],
                                  single[f"lm_{case}"]["logits"][0])


@pytest.mark.parametrize("case", list(LM))
@pytest.mark.parametrize("shape", MESHES)
def test_decode_logits_bitwise_one_device(meshed, single, shape, case):
    _equal(_shared(meshed, shape, f"lm_{case}")["logits"][1:],
           single[f"lm_{case}"]["logits"][1:])


def _want_slices(case, m):
    """(columns, rows) a rank holds of each projection (packed rows: two
    4-bit digits a byte); the fp baseline's contraction axes whole."""
    api = _api(case)
    cfg = api.cfg
    fp = LM[case][1]
    vp = pad_vocab(cfg.vocab)
    rows = (lambda k: k) if fp else (lambda k: k // 2)
    out = {"head": (vp // m, rows(cfg.d_model)), "embed_rows": vp // m}
    d = cfg.d_model
    if api.family == "ssm":
        s = cfg.ssm
        di, gn, h = s.d_inner, 2 * s.n_groups * s.d_state, s.n_heads
        out.update(in_xbc=(di // m + gn, rows(d)), in_z=(di // m, rows(d)),
                   in_dt=(h // m, rows(d)),
                   out=(d, rows(di) if fp else rows(di) // m),
                   conv=(s.conv_width, di // m + gn), a_log=h // m)
    elif api.family == "hybrid":
        dr = cfg.rnn.d_rnn
        hd = cfg.n_heads * cfg.hd
        out.update(in_x=(dr // m, rows(d)), w_a=(dr, rows(dr) // m),
                   w_x=(dr, rows(dr) // m), out=(d, rows(dr) // m),
                   w_a_gamma=dr // m, conv=(4, dr // m), lam=dr // m,
                   q=(hd // m, rows(d)), k=(cfg.n_kv * cfg.hd, rows(d)),
                   o=(d, rows(hd) // m), gate=(cfg.d_ff // m, rows(d)),
                   down=(d, rows(cfg.d_ff) // m))
    else:
        hd = cfg.n_heads * cfg.hd
        out.update(q=(hd // m, d), k=(cfg.n_kv * cfg.hd, d), o=(d, hd))
        if cfg.moe is not None:
            out["bank"] = (cfg.moe.n_experts // m, d, cfg.moe.d_ff)
        else:
            out.update(up=(cfg.d_ff // m, d), down=(d, cfg.d_ff))
    return out


def _state_block(path, whole, r, m, case):
    """Rank ``r``'s block of a one-device decode-state leaf: an SSM's
    heads, an SSM conv's pieces (``xbc_pieces``), an RG-LRU state's
    channels, a ring's slots, a KV cache's positions (its length rounded
    up to a multiple of M, the tail zeros)."""
    if _api(case).family in ("dense", "moe"):
        n = -(-whole.shape[1] // m) * m
        pad = np.zeros((whole.shape[0], n - whole.shape[1])
                       + whole.shape[2:], whole.dtype)
        return np.concatenate([whole, pad], 1)[:, _block_of(n, r, m)]
    if path.endswith(".ssm"):
        return whole[:, _block_of(whole.shape[1], r, m)]
    if path.startswith(".l0.conv"):
        s = _api(case).cfg.ssm
        idx = np.concatenate([np.arange(a, b) for a, b in
                              nnssm.xbc_pieces(s, r, m)])
        return whole[..., idx]
    if path.startswith(".a2"):
        return whole[:, _block_of(whole.shape[1], r, m)]
    return whole[..., _block_of(whole.shape[-1], r, m)]


def _block_of(n, r, m):
    return slice(r * n // m, (r + 1) * n // m)


@pytest.mark.parametrize("case", list(LM))
@pytest.mark.parametrize("shape", MESHES)
def test_every_rank_holds_its_slice(meshed, single, shape, case):
    """Each rank: its heads' (channels') columns of every column shard,
    their rows of every row shard (the fp baseline's rows whole), mamba2's
    x columns of ``in_xbc`` and the conv with B and C whole, its block of
    the vocabulary; and of the decode state its heads of the SSM state,
    its conv pieces, its RG-LRU channels and its block of the 8 ring
    slots, each the single-device state's block of its data coordinate's
    rows (recurrentgemma's ring, wrapped, included)."""
    d, m = shape
    name = f"lm_{case}"
    rows = 2 // d
    whole = single[name]["cache"]
    for r in range(WORLD):
        res = meshed[r][shape][name]
        pr = res["per_rank"]
        assert pr["slices"] == _want_slices(case, m), (shape, r)
        assert (pr["data"], pr["model"]) == (r // m, r % m)
        dc, mr = pr["data"], pr["model"]

        def check(want, got, path=""):
            if isinstance(want, dict):
                for k in want:
                    check(want[k], got[k], f"{path}.{k}")
            elif isinstance(want, (list, tuple)):
                for i, w in enumerate(want):
                    check(w, got[i], f"{path}[{i}]")
            else:
                w = _state_block(path, want[dc * rows:(dc + 1) * rows],
                                 mr, m, case)
                np.testing.assert_array_equal(got, w, err_msg=path)
        check(whole, res["cache"])


@pytest.mark.parametrize("shape", MESHES)
def test_generate_scheduler_over_recurrentgemma(meshed, single, shape):
    got = _shared(meshed, shape, "scheduler")
    _equal(got["results"], single["scheduler"]["alone"])
    _equal(got["alone"], single["scheduler"]["alone"])


# --- units -----------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES)
def test_gates_as_row_shards_bitwise_the_whole(meshed, single, shape):
    """Each rank's ``w_a``/``w_x`` row shard, its int32 sums all-reduced
    (the fp baseline: its input all-gathered), gives its channels of the
    whole product, bitwise."""
    want = single["gates"]
    for r in range(WORLD):
        got = meshed[r][shape]["gates"]
        for tag in ("packed", "fp"):
            lo, hi = got[f"{tag}_blk"]
            assert hi - lo == 64 // shape[1]
            for key in ("w_a", "w_x"):
                np.testing.assert_array_equal(
                    got[f"{tag}_{key}"], want[f"{tag}_{key}"][..., lo:hi],
                    err_msg=f"{shape} rank {r} {tag} {key}")


@pytest.mark.parametrize("shape", MESHES)
def test_ring_split_decode_bitwise(meshed, shape):
    """The ring's split decode over a rank's heads and slots is
    ``decode_attention`` on the whole ring, wrapped or not."""
    q, ck, cv = _ring_inputs()
    for r in range(WORLD):
        got = meshed[r][shape]["ring"]
        lo, hi = got["heads"]
        for n in (8, 5):
            want = A.decode_attention(q, ck, cv, n)[:, :, lo:hi]
            np.testing.assert_array_equal(got[f"o{n}"],
                                          want.float().numpy(),
                                          err_msg=f"{shape} rank {r} {n}")


@pytest.mark.parametrize("m", [2, 4])
def test_in_xbc_pieces_bitwise_the_whole_columns(weights, m):
    """A rank's ``in_xbc`` pieces (its heads' x columns, B and C) through
    K1's plain twin are the whole layer's columns, bitwise, packed and
    fp."""
    api = _api("mamba2")
    s = api.cfg.ssm
    g = torch.Generator().manual_seed(61)
    x = torch.randn(3, 7, api.cfg.d_model, generator=g).to(torch.bfloat16)
    train = _trains({MAMBA: weights[MAMBA]})[MAMBA]
    for pol in (api.policy, FP):
        a = dataclasses.replace(api, policy=pol)
        layer = pack_for_serving(a, train)["layers"][0]["ssm"]["in_xbc"]
        whole = Q.qlinear_serve_apply(layer, x, pol, name="in_xbc")
        for r in range(m):
            pieces = nnssm.xbc_pieces(s, r, m)
            got = Q.qlinear_serve_apply(Q.column_pieces(layer, pieces), x,
                                        pol, name="in_xbc")
            idx = np.concatenate([np.arange(p, q) for p, q in pieces])
            assert got.shape[-1] == s.d_inner // m + 2 * s.d_state
            np.testing.assert_array_equal(got.float().numpy(),
                                          whole[..., idx].float().numpy())


@pytest.mark.parametrize("m", [2, 4])
def test_fp_column_shard_runs_at_the_padded_shape(m, monkeypatch):
    """An fp column shard (``fp_shard``) multiplies at the one-device N,
    its weight zero-padded, and keeps its columns: bitwise the whole
    product's columns; so does a bank's expert shard, padded to all
    experts."""
    g = torch.Generator().manual_seed(71)
    x = torch.randn(5, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 96, generator=g).to(torch.bfloat16)
    shapes = []
    real = torch.matmul

    def spy(a, b):
        shapes.append(tuple(b.shape))
        return real(a, b)
    whole = real(x, w)
    monkeypatch.setattr(torch, "matmul", spy)
    for r in range(m):
        n = 96 // m
        p = Q.fp_shard({"w": w}, -1, ((r * n, (r + 1) * n),))
        assert p["w"].shape == (64, n)
        got = Q.qlinear_serve_apply(p, x, FP)
        np.testing.assert_array_equal(got.float().numpy(),
                                      whole[:, r * n:(r + 1) * n]
                                      .float().numpy())
    assert set(shapes) == {(64, 96)}
    monkeypatch.setattr(torch, "matmul", real)
    xb = torch.randn(8, 3, 16, generator=g).to(torch.bfloat16)
    bank = torch.randn(8, 16, 24, generator=g).to(torch.bfloat16)
    wb = real(xb, bank)
    for r in range(m):
        e = 8 // m
        p = Q.fp_shard({"w": bank}, -3, ((r * e, (r + 1) * e),))
        got = Q.qlinear_serve_apply(p, xb[r * e:(r + 1) * e], FP)
        np.testing.assert_array_equal(got.float().numpy(),
                                      wb[r * e:(r + 1) * e].float().numpy())


# --- entry points ------------------------------------------------------------


@pytest.mark.parametrize("case", list(LM))
def test_entry_points_accept_every_case(case):
    """``require_tensor_parallel`` and ``launch.serve``'s mesh check pass
    mamba2, recurrentgemma and the fp baseline at M = 2 and 4."""
    api = _api(case)
    for m in (2, 4):
        require_tensor_parallel(api, {"data": 1, "model": m})
        argv = ["--arch", LM[case][0], "--reduced", "--device", "cpu",
                "--mesh", f"1x{m}"] + (["--fp-baseline"] if LM[case][1]
                                       else [])
        args = launch_serve._parser().parse_args(argv)
        assert launch_serve._world(args) == (m, m, True)


@pytest.mark.parametrize("arch,what,n", [(MAMBA, "heads", 6),
                                         (RG, "window slots", 6)])
def test_uneven_split_names_both_numbers(arch, what, n):
    """mamba2's SSD heads and recurrentgemma's window (its ring's slots)
    must split over M."""
    api = configs.get(arch, reduced=True)
    cfg = api.cfg
    if arch == MAMBA:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, expand=3))           # 192 / 32 = 6 heads
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=32))
    else:
        cfg = dataclasses.replace(cfg, window=6)
    api = dataclasses.replace(api, cfg=cfg)
    with pytest.raises(ValueError, match=f"{n} {what} .* of 4"):
        require_tensor_parallel(api, {"data": 1, "model": 4})


def test_mamba2_serves_over_two_ranks_from_the_cli(capfd):
    """``launch.serve --arch mamba2-1.3b --devices 2 --mesh 1x2`` prints
    the single-device run's greedy sample."""
    argv = ["--arch", MAMBA, "--reduced", "--device", "cpu", "--batch",
            "2", "--prompt-len", "5", "--new-tokens", "3"]
    samples = []
    for extra in ([], ["--devices", "2", "--mesh", "1x2"]):
        assert launch_serve.main(argv + extra) == 0
        samples.append([ln for ln in capfd.readouterr().out.splitlines()
                        if "sample:" in ln])
    assert len(samples[0]) == 1
    assert samples[0] == samples[1]

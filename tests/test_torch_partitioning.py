"""The port's logical-axis rules, meshes and input descriptions
(``repro_torch.nn.partitioning``, ``launch.mesh``, ``launch.steps``)
against ``repro``'s.

One counterpart for each class of ``tests/test_partitioning.py``, then the
whole matrix: every arch x {train, serve} x {TRAIN_RULES, SERVE_RULES,
TRAIN_RULES_SEQ} x {(data, model), (pod, data, model)}, over
``param_axes``, ``cache_axes`` and ``input_axes``, each spec equal to
``repro``'s.  The port keeps one entry a layer where ``repro`` stacks a
scanned group along a leading 'layers' axis (which every rule maps to
``None``): a stacked leaf's counterpart is the port's leaf of each layer,
whose axes and spec are ``repro``'s without that first entry.
"""
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES as JSHAPES
from repro.core.plan import PrecisionPlan as JPlan
from repro.launch import steps as jsteps
from repro.models import transformer as jtransformer
from repro.nn import param as jnnp
from repro.nn import partitioning as jpart
from repro_torch import configs, convert
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.plan import PrecisionPlan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.nn import partitioning as part

RULES = {"TRAIN_RULES": (part.TRAIN_RULES, jpart.TRAIN_RULES),
         "SERVE_RULES": (part.SERVE_RULES, jpart.SERVE_RULES),
         "TRAIN_RULES_SEQ": (part.TRAIN_RULES_SEQ, jpart.TRAIN_RULES_SEQ)}
MESHES = {"data-model": ("data", "model"),
          "pod-data-model": ("pod", "data", "model")}
MIXED_PLAN = "examples/plans/granite_8b_mixed.json"
# every arch under its default policy, and granite-8b under a mixed plan
# with a packed KV cache (format groups, packed cache leaves)
ARCHS = [(a, None) for a in configs.ARCH_NAMES] + [("granite-8b", MIXED_PLAN)]
LM_ARCHS = [(a, p) for a, p in ARCHS if a in configs.LM_NAMES]


def _ids(cases):
    return [a if p is None else f"{a}+plan" for a, p in cases]


def _mesh_like(names):
    return SimpleNamespace(axis_names=names,
                           devices=np.zeros((1,) * len(names)))


@functools.lru_cache(maxsize=None)
def _jmesh(names):
    return jax.make_mesh((1,) * len(names), names)


@functools.lru_cache(maxsize=None)
def _apis(arch, plan):
    if plan is None:
        return configs.get(arch), jconfigs.get(arch)
    return (configs.get(arch, policy=PrecisionPlan.load(plan)),
            jconfigs.get(arch, policy=JPlan.load(plan)))


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _leaves(tree, path=""):
    """[(path, axes tuple)] in traversal order (dicts by sorted key)."""
    if _is_axes(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}[{k!r}]")]
    return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}[{i}]")]


class _Ax:
    """One reference leaf's logical axes (and whether it was stacked),
    carried through ``convert``'s unstacking as an opaque object."""

    def __init__(self, axes, stacked):
        self.axes, self.stacked = axes, stacked


def _ref_param_counterparts(api_j, mode, monkeypatch):
    """``repro``'s param axes rearranged into the port's tree by the same
    unstacking ``convert`` applies to weights: leaves ``_Ax``."""
    specs = jnnp.strip_markers(api_j.specs(mode))

    def wrap(s):
        if s.axes and s.axes[0] == "layers":
            arr = np.empty(s.shape[0], dtype=object)
            for i in range(s.shape[0]):
                arr[i] = _Ax(s.axes, True)
            return arr
        arr = np.empty((), dtype=object)
        arr[()] = _Ax(s.axes or (None,) * len(s.shape), False)
        return arr

    tree = jax.tree.map(wrap, specs, is_leaf=jnnp.is_spec)
    monkeypatch.setattr(convert, "from_numpy", lambda arr, dev: arr)
    if api_j.family == "cnn":
        out = convert._convert(tree, torch.device("cpu"))
    else:
        out = convert.from_jax_lm_train_params(tree, device="cpu")
    return _unwrap(out)


def _unwrap(tree):
    if isinstance(tree, dict):
        return {k: _unwrap(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unwrap(v) for v in tree]
    return tree.item() if isinstance(tree, np.ndarray) else tree


def _flat_ax(tree, path=""):
    if isinstance(tree, _Ax):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat_ax(tree[k],
                                                          f"{path}[{k!r}]")]
    return [x for i, v in enumerate(tree) for x in _flat_ax(v, f"{path}[{i}]")]


def _ref_spec(axes, stacked, rules, names):
    spec = tuple(jpart.logical_to_spec(axes, rules, _jmesh(names)))
    return spec[1:] if stacked and spec else spec


# --- one counterpart for each class of tests/test_partitioning.py ----------


class TestLogicalToSpec:
    @pytest.mark.parametrize("axes,rules,names", [
        (("batch", "seq", "act_embed"), "TRAIN_RULES", None),
        (("batch", None, "mlp"), "TRAIN_RULES", ("data", "model")),
        (("embed", None, None), "TRAIN_RULES", None),
        (("embed", "mlp"), "SERVE_RULES", None),
        (("plane", "mlp_packed", "act_embed"), "SERVE_RULES", None),
        (("batch", "seq", "heads"), "TRAIN_RULES_SEQ", ("pod", "data",
                                                        "model")),
        (("experts", "embed", "expert_mlp"), "SERVE_RULES", ("data",
                                                              "model")),
    ])
    def test_equals_repro(self, axes, rules, names):
        ours, theirs = RULES[rules]
        mesh = _mesh_like(names) if names else None
        want = jpart.logical_to_spec(axes, theirs,
                                     _jmesh(names) if names else None)
        assert part.logical_to_spec(axes, ours, mesh) == tuple(want)

    def test_basic_mapping(self):
        assert part.logical_to_spec(("batch", "seq", "act_embed"),
                                    part.TRAIN_RULES) == (("pod", "data"),)

    def test_mesh_drops_missing_axes(self):
        spec = part.logical_to_spec(("batch", None, "mlp"), part.TRAIN_RULES,
                                    _mesh_like(("data", "model")))
        assert spec == ("data", None, "model")

    def test_duplicate_mesh_axis_first_wins(self):
        assert part.logical_to_spec(("a", "b"), {"a": "model",
                                                 "b": "model"}) == ("model",)

    def test_trailing_nones_trimmed(self):
        assert part.logical_to_spec(("embed", None, None),
                                    part.TRAIN_RULES) == (("pod", "data"),)

    def test_rule_sets_equal_repro(self):
        for ours, theirs in RULES.values():
            assert ours == theirs

    def test_kv_seq_sharded_at_serve_only(self):
        assert part.SERVE_RULES["kv_seq"] == "model"
        assert part.TRAIN_RULES["kv_seq"] is None

    def test_axis_rules_context(self):
        assert part.current_rules() is part.TRAIN_RULES
        with part.axis_rules(part.SERVE_RULES):
            assert part.current_rules() is part.SERVE_RULES
            assert part.logical_to_spec(("embed", "mlp")) == (None, "model")
        assert part.current_rules() is part.TRAIN_RULES


class TestBatchRules:
    @pytest.mark.parametrize("rules", list(RULES))
    @pytest.mark.parametrize("batch,shape,names", [
        (256, (1, 1), ("data", "model")), (1, (1, 1), ("data", "model")),
        (3, (2, 1), ("data", "model")), (8, (2, 4, 1), ("pod", "data",
                                                        "model")),
        (4, (2, 4, 1), ("pod", "data", "model")), (128, (16, 16),
                                                   ("data", "model"))])
    def test_equals_repro(self, rules, batch, shape, names):
        ours, theirs = RULES[rules]
        fake = SimpleNamespace(axis_names=names, devices=np.zeros(shape))
        assert (steps_lib.batch_rules_for(ours, batch, fake)
                == jsteps.batch_rules_for(theirs, batch, fake))

    def test_indivisible_batch_drops_axis(self):
        fake = SimpleNamespace(axis_names=("data", "model"),
                               devices=np.zeros((2, 1)))
        rules = steps_lib.batch_rules_for(part.SERVE_RULES, 3, fake)
        assert rules["batch"] is None


class TestMesh:
    def test_local_mesh(self):
        mesh = mesh_lib.make_local_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert mesh_lib.chips(mesh) == 1
        assert mesh_lib.mesh_axes(mesh) == (("data", 1), ("model", 1))
        assert mesh_lib.local_device(mesh) == torch.device("cpu")

    def test_serve_mesh_defaults_to_the_world(self):
        mesh = mesh_lib.make_serve_mesh(device="cpu")
        assert part.axis_sizes(mesh) == {"data": 1, "model": 1}
        assert mesh_lib.data_coords(mesh) == (0, 1)

    def test_serve_mesh_rejects_infeasible_shapes(self):
        with pytest.raises(ValueError):  # more ranks than the world has
            mesh_lib.make_serve_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError):  # model axis > world: data = 0
            mesh_lib.make_serve_mesh(model=2, device="cpu")
        # a 'model' axis above 1 is served (tensor-parallel), on its ranks
        with pytest.raises(ValueError, match="needs 2 ranks"):
            mesh_lib.make_serve_mesh(1, 2, device="cpu")
        with pytest.raises(NotImplementedError, match="multi-pod"):
            part.require_serve_mesh({"pod": 2, "data": 1, "model": 1})

    def test_production_mesh_needs_its_world(self):
        with pytest.raises(ValueError, match="256"):
            mesh_lib.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="512"):
            mesh_lib.make_production_mesh(multi_pod=True, device="cpu")

    def test_cuda_mesh_needs_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_lib.make_serve_mesh()

    def test_parse_mesh_spec(self):
        assert mesh_lib.parse_mesh_spec("8x1") == (8, 1)
        assert mesh_lib.parse_mesh_spec("4X2") == (4, 2)
        for bad in ("8", "0x4", "ax2"):
            with pytest.raises(ValueError):
                mesh_lib.parse_mesh_spec(bad)

    def test_world_of_one_is_the_identity(self):
        mesh = mesh_lib.make_serve_mesh(device="cpu")
        x = torch.arange(6).reshape(2, 3)
        assert mesh_lib.gather_rows(mesh, x) is x
        assert mesh_lib.broadcast_value(mesh, 2.5) == 2.5
        clock = lambda: 1.0  # noqa: E731
        assert mesh_lib.shared_clock(clock, mesh) is clock


class TestTreeShardings:
    def test_tree_map_over_axes_tree(self):
        mesh = mesh_lib.make_local_mesh(device="cpu")
        axes = {"w": ("embed", "mlp"), "b": ("mlp",), "scalar": (),
                "pair": [("batch", "kv_seq"), ("batch", None)]}
        sh = part.tree_shardings(axes, mesh, part.TRAIN_RULES)
        assert sh["w"].spec == ("data", "model")
        assert sh["scalar"].spec == ()
        assert sh["pair"][0].spec == ("data",)
        from torch.distributed.tensor import Replicate, Shard
        assert sh["w"].placements == (Shard(0), Shard(1))
        assert sh["b"].placements == (Replicate(), Shard(0))
        assert sh["w"].is_fully_replicated  # every axis of size 1
        assert part.replicated(mesh).placements == (Replicate(), Replicate())

    def test_equals_repro(self):
        axes = {"w": ("embed", "mlp"), "b": ("mlp",), "scalar": ()}
        names = ("pod", "data", "model")
        for ours, theirs in RULES.values():
            got = part.tree_shardings(axes, _mesh_like(names), ours)
            want = jpart.tree_shardings(axes, _jmesh(names), theirs)
            for k in axes:
                assert got[k].spec == tuple(want[k].spec)


class TestConstrain:
    def test_constrain_is_noop_without_mesh(self):
        x = torch.ones(4, 4)
        assert part.constrain(x, ("batch", "act_embed")) is x

    def test_constrain_is_noop_on_data_mesh(self):
        x = torch.ones(4, 4)
        with part.axis_rules(part.SERVE_RULES,
                             _mesh_like(("data", "model"))):
            assert part.constrain(x, ("batch", "act_embed")) is x

    def test_constrain_raises_on_model_axis(self):
        """A 'model' axis above 1 is served (its activations replicated by
        the tensor-parallel layers' collectives): a no-op; a multi-pod
        mesh, which no serve path covers, raises."""
        x = torch.ones(2)
        fake = SimpleNamespace(axis_names=("data", "model"),
                               devices=np.zeros((2, 2)))
        with part.axis_rules(part.SERVE_RULES, fake):
            assert part.constrain(x, ("batch",)) is x
        pod = SimpleNamespace(axis_names=("pod", "data", "model"),
                              devices=np.zeros((2, 1, 2)))
        with part.axis_rules(part.SERVE_RULES, pod):
            with pytest.raises(NotImplementedError, match="multi-pod"):
                part.constrain(x, ("batch",))


class TestInputSpecs:
    def test_train_specs(self):
        specs = steps_lib.input_specs(configs.get("granite-8b"),
                                      SHAPES["train_4k"])
        assert specs["tokens"].shape == (256, 4096)
        assert specs["labels"].shape == (256, 4096)

    def test_decode_specs_have_cache(self):
        specs = steps_lib.input_specs(configs.get("granite-8b"),
                                      SHAPES["decode_32k"])
        assert specs["tokens"].shape == (128, 1)
        assert specs["cache"][0][0].shape[1] == 32768  # (B, S, KV, HD)

    @pytest.mark.parametrize("shape", list(SHAPES))
    @pytest.mark.parametrize("arch,plan", LM_ARCHS, ids=_ids(LM_ARCHS))
    def test_shapes_equal_repro(self, arch, plan, shape):
        api, api_j = _apis(arch, plan)
        got = steps_lib.input_specs(api, SHAPES[shape])
        want = jsteps.input_specs(api_j, JSHAPES[shape])
        assert sorted(got) == sorted(want)
        for k in got:
            if k == "cache":
                continue
            assert tuple(got[k].shape) == tuple(want[k].shape), k
        if "cache" in got:
            port = [tuple(s.shape) for s in _spec_leaves(got["cache"])]
            ref = _ref_cache_tree(api_j, jax.tree.map(
                lambda s: tuple(s.shape), want["cache"],
                is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)),
                lambda t: t[1:], is_leaf=lambda x: isinstance(x, tuple)
                and all(isinstance(d, int) for d in x))
            assert port == [x for _, x in _shape_leaves(ref)]


def _spec_leaves(tree):
    from repro_torch.nn.param import is_spec
    if is_spec(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    return [x for v in tree for x in _spec_leaves(v)]


def _shape_leaves(tree, path=""):
    if isinstance(tree, tuple) and all(isinstance(d, int) for d in tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _shape_leaves(tree[k],
                                                              f"[{k!r}]")]
    return [x for i, v in enumerate(tree) for x in _shape_leaves(v, f"[{i}]")]


# --- the matrix ------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch,plan", ARCHS, ids=_ids(ARCHS))
def test_param_axes_and_specs_equal_repro(arch, plan, mode, rules, mesh,
                                          monkeypatch):
    api, api_j = _apis(arch, plan)
    ours_rules, ref_rules = RULES[rules]
    names = MESHES[mesh]
    ours = api.param_axes(mode)
    ref = _ref_param_counterparts(api_j, mode, monkeypatch)
    got = _leaves(ours)
    want = _flat_ax(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    shardings = _leaves_sh(part.tree_shardings(ours, _mesh_like(names),
                                               ours_rules))
    for (path, axes), (_, ax), sh in zip(got, want, shardings):
        assert axes == (ax.axes[1:] if ax.stacked else ax.axes), path
        assert sh.spec == _ref_spec(ax.axes, ax.stacked, ref_rules,
                                    names), path


def _leaves_sh(tree):
    if isinstance(tree, part.NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sh(tree[k])]
    return [x for v in tree for x in _leaves_sh(v)]


def _ref_cache_tree(api_j, ref, leaf, is_leaf=_is_axes):
    """``repro``'s cache tree (of axes or shapes) rearranged into the
    port's per-layer layout, ``leaf`` applied to each stacked leaf."""
    cfg = api_j.cfg
    m = lambda t: jax.tree.map(leaf, t, is_leaf=is_leaf)  # noqa: E731
    fam = api_j.family
    if fam == "ssm":
        return [m(ref) for _ in range(cfg.n_layers)]
    if fam == "hybrid":
        out = []
        for _ in range(cfg.n_super):
            out += [m(ref["r1"]), m(ref["r2"]), (leaf(ref["k"]),
                                                 leaf(ref["v"]))]
        return out + [m(r) for r in ref["rem"]]
    if fam == "audio":
        return {"self": [tuple(m(x) for x in ref["self"])
                         for _ in range(cfg.n_layers)],
                "cross": [tuple(m(x) for x in ref["cross"])
                          for _ in range(cfg.n_layers)]}
    if isinstance(ref, dict):  # packed KV cache: one subtree a format group
        groups = jtransformer.scan_format_groups(cfg, api_j.policy)
        return [m(ref[f"g{j}"]) for j, (_s, n) in enumerate(groups)
                for _ in range(n)]
    return [tuple(m(x) for x in ref) for _ in range(cfg.n_layers)]


def _drop_layers(ax):
    assert ax[0] == "layers", ax
    return ax[1:]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch,plan", LM_ARCHS, ids=_ids(LM_ARCHS))
def test_cache_axes_and_specs_equal_repro(arch, plan, rules, mesh):
    api, api_j = _apis(arch, plan)
    ours_rules, ref_rules = RULES[rules]
    names = MESHES[mesh]
    ref = api_j.cache_axes()
    got = _leaves(api.cache_axes())
    want = _leaves(_ref_cache_tree(api_j, ref, _drop_layers))
    assert got == want
    ref_full = _leaves(_ref_cache_tree(api_j, ref, lambda a: a))
    shardings = _leaves_sh(part.tree_shardings(api.cache_axes(),
                                               _mesh_like(names), ours_rules))
    for (path, _), (_, full), sh in zip(got, ref_full, shardings):
        assert sh.spec == _ref_spec(full, True, ref_rules, names), path
    # the cache tree the axes describe
    assert [p for p, _ in got] == [p for p, _ in _leaves(
        steps_lib.input_axes(api, SHAPES["decode_32k"])["cache"])]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch,plan", LM_ARCHS, ids=_ids(LM_ARCHS))
def test_input_axes_and_specs_equal_repro(arch, plan, shape, rules, mesh):
    api, api_j = _apis(arch, plan)
    ours_rules, ref_rules = RULES[rules]
    names = MESHES[mesh]
    got = steps_lib.input_axes(api, SHAPES[shape])
    want = jsteps.input_axes(api_j, JSHAPES[shape])
    assert sorted(got) == sorted(want)
    sh = part.tree_shardings(got, _mesh_like(names), ours_rules)
    for k in got:
        if k == "cache":
            continue
        assert got[k] == want[k]
        assert sh[k].spec == _ref_spec(want[k], False, ref_rules, names)
    if "cache" in got:
        assert _leaves(got["cache"]) == _leaves(
            _ref_cache_tree(api_j, want["cache"], _drop_layers))


def test_abstract_params_on_meta():
    api = configs.get("granite-8b")
    tree = api.abstract_params("serve")
    leaf = tree["layers"][0]["attn"]["q"]["planes"]
    assert leaf.device.type == "meta" and leaf.dtype == torch.uint8
    want = jconfigs.get("granite-8b").abstract_params("serve")
    ref = want["layers"]["attn"]["q"]["planes"]
    assert tuple(leaf.shape) == tuple(ref.shape)[1:]


def test_partition_spec_counterpart():
    """A port spec is a tuple with the entries of ``repro``'s
    ``PartitionSpec``."""
    assert tuple(P(("pod", "data"), None, "model")) == (("pod", "data"),
                                                        None, "model")


def test_data_rows_split_and_refuse_a_ragged_batch():
    """A rank's rows of a padded batch; a batch that does not split over
    the data ranks raises instead of dropping rows."""
    rows = mesh_lib.DataRows()
    x = torch.arange(6).reshape(3, 2)
    assert rows.local(x) is x and rows.gather(x) is x and rows.pad_to(3) == 3
    rows.rank, rows.n = 1, 2
    assert rows.pad_to(3) == 4
    assert rows.local(torch.arange(8).reshape(4, 2)).tolist() == [[4, 5],
                                                                   [6, 7]]
    with pytest.raises(ValueError, match="does not split"):
        rows.local(x)

"""Layer-wise precision plans: one (w_Q, k, channel_wise, dataflow) per layer.

Port of the serving half of ``repro.core.plan``.  The JSON schema is the
JAX package's, so the port reads ``examples/plans/*.json`` in place:

    {
      "version": 2,
      "a_bits": 8, "variant": "st",
      "default": {"w_bits": 8, "k": 4, "channel_wise": false,
                  "dataflow": "auto"},
      "kv": {"bits": 4, "k": 4, "store": "packed"},
      "layers": {"s0b0c1": {"w_bits": 2, "k": 2},
                 "k": {"w_bits": 4, "k": 4, "kv_bits": 2}, ...}
    }

Layer names are the model's ``gemm_workload`` names.  Resolution is
hierarchical: an exact entry wins, else scope prefixes are stripped one
at a time (``l3.q`` falls back to ``q``), else the plan default applies.
Boundary layers stay pinned through ``PrecisionPolicy.bits_for``.

A ``FrontierManifest`` orders N plans of one model accurate -> fast (the
serving degradation ladder; ``examples/frontiers/*.json``), each point an
inline plan or a path relative to the manifest.

Schema v2 adds the decode KV cache: the plan-level ``kv`` section sets the
cache-wide word-length, slice and store ('packed' digit planes or the
'qdq' bf16 oracle layout), and ``kv_bits`` on a ``k``/``v`` entry (or a
scoped ``l{i}.k``) overrides it through the same lookup.  A version-1
file carrying kv keys is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.precision import (PrecisionPolicy, VALID_SLICES,
                                        VALID_WBITS)

__all__ = [
    "LayerPlan",
    "KVCachePlan",
    "PrecisionPlan",
    "FrontierEntry",
    "FrontierManifest",
    "as_plan",
    "resolve_policy",
    "resolve_dataflow",
    "resolve_kv_bits",
    "strip_kv",
    "kv_cache_token_bytes",
    "plan_footprint_report",
    "validate_plan_json",
    "validate_frontier_json",
    "main",
    "VALID_KV_BITS",
]

SUPPORTED_PLAN_VERSIONS = (1, 2)
FRONTIER_VERSION = 1
VALID_DATAFLOWS = ("auto", "im2col", "implicit")
VALID_KV_BITS = (2, 4, 8)
VALID_KV_STORES = ("packed", "qdq")

PolicyOrPlan = Union[PrecisionPolicy, "PrecisionPlan"]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's deployment format."""

    w_bits: int = 8
    k: int = 4
    channel_wise: bool = False
    dataflow: str = "auto"
    kv_bits: Optional[int] = None   # cache word-length of a k/v entry

    def __post_init__(self):
        if self.w_bits not in VALID_WBITS:
            raise ValueError(f"w_bits must be in {VALID_WBITS}, "
                             f"got {self.w_bits}")
        if self.k not in VALID_SLICES:
            raise ValueError(f"k must be in {VALID_SLICES}, got {self.k}")
        if self.dataflow not in VALID_DATAFLOWS:
            raise ValueError(f"dataflow must be in {VALID_DATAFLOWS}, "
                             f"got {self.dataflow!r}")
        if self.kv_bits is not None and self.kv_bits not in VALID_KV_BITS:
            raise ValueError(f"kv_bits must be in {VALID_KV_BITS}, "
                             f"got {self.kv_bits}")

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "w_bits": self.w_bits, "k": self.k,
            "channel_wise": self.channel_wise, "dataflow": self.dataflow}
        if self.kv_bits is not None:
            out["kv_bits"] = self.kv_bits
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, object]) -> "LayerPlan":
        extra = set(obj) - {"w_bits", "k", "channel_wise", "dataflow",
                            "kv_bits"}
        if extra:
            raise ValueError(f"unknown layer-plan keys: {sorted(extra)}")
        kv_bits = obj.get("kv_bits")
        return cls(
            w_bits=int(obj.get("w_bits", 8)),
            k=int(obj.get("k", 4)),
            channel_wise=bool(obj.get("channel_wise", False)),
            dataflow=str(obj.get("dataflow", "auto")),
            kv_bits=None if kv_bits is None else int(kv_bits),
        )


@dataclasses.dataclass(frozen=True)
class KVCachePlan:
    """Plan-wide decode KV-cache section (schema v2).

    bits: cache-wide default word-length (None: layers without their own
    ``kv_bits`` keep a bf16 cache); k: digit-plane slice (a layer's slice
    is ``min(bits, k)``); store: 'packed' or 'qdq'.
    """

    bits: Optional[int] = None
    k: int = 4
    store: str = "packed"

    def __post_init__(self):
        if self.bits is not None and self.bits not in VALID_KV_BITS:
            raise ValueError(f"kv bits must be in {VALID_KV_BITS}, "
                             f"got {self.bits}")
        if self.k not in VALID_SLICES:
            raise ValueError(f"kv k must be in {VALID_SLICES}, got {self.k}")
        if self.store not in VALID_KV_STORES:
            raise ValueError(f"kv store must be in {VALID_KV_STORES}, "
                             f"got {self.store!r}")

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {"k": self.k, "store": self.store}
        if self.bits is not None:
            out["bits"] = self.bits
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, object]) -> "KVCachePlan":
        extra = set(obj) - {"bits", "k", "store"}
        if extra:
            raise ValueError(f"unknown kv-section keys: {sorted(extra)}")
        bits = obj.get("bits")
        return cls(bits=None if bits is None else int(bits),
                   k=int(obj.get("k", 4)),
                   store=str(obj.get("store", "packed")))


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Layer name -> LayerPlan mapping plus the plan-wide knobs.

    ``layers`` is a sorted tuple of (name, LayerPlan), so the plan is
    hashable like a ``PrecisionPolicy``.
    """

    layers: Tuple[Tuple[str, LayerPlan], ...] = ()
    default: LayerPlan = LayerPlan()
    a_bits: int = 8
    boundary_bits: int = 8
    variant: str = "st"
    quantize: bool = True
    name: str = ""
    arch: str = ""
    kv: Optional[KVCachePlan] = None

    def __post_init__(self):
        if self.variant not in ("st", "sa"):
            raise ValueError("variant must be 'st' or 'sa'")
        if self.boundary_bits not in VALID_WBITS:
            raise ValueError(f"boundary_bits must be in {VALID_WBITS}")
        if self.default.kv_bits is not None:
            raise ValueError("the plan default may not carry kv_bits; set "
                             "the plan-level 'kv' section instead")
        names = [n for n, _ in self.layers]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate plan layers: {dupes}")
        object.__setattr__(self, "layers",
                           tuple(sorted(self.layers, key=lambda e: e[0])))
        object.__setattr__(self, "_entries", dict(self.layers))

    @classmethod
    def build(cls, layers: Mapping[str, LayerPlan], **kw) -> "PrecisionPlan":
        return cls(layers=tuple(layers.items()), **kw)

    @classmethod
    def uniform(cls, policy: PrecisionPolicy,
                name: str = "") -> "PrecisionPlan":
        """The degenerate single-entry plan of a uniform policy."""
        return cls(
            layers=(),
            default=LayerPlan(w_bits=policy.inner_bits, k=policy.k,
                              channel_wise=policy.channel_wise),
            a_bits=policy.a_bits, boundary_bits=policy.boundary_bits,
            variant=policy.variant, quantize=policy.quantize,
            name=name or f"uniform_w{policy.inner_bits}k{policy.k}")

    def layer(self, name: str) -> LayerPlan:
        """Exact entry, else the name with scope prefixes stripped one
        segment at a time, else the plan default."""
        probe = name
        while True:
            if probe in self._entries:
                return self._entries[probe]
            if "." not in probe:
                return self.default
            probe = probe.split(".", 1)[1]

    def policy_for(self, name: str) -> PrecisionPolicy:
        """Collapse one layer's entry into the kernel-facing policy."""
        lp = self.layer(name)
        return PrecisionPolicy(
            a_bits=self.a_bits, inner_bits=lp.w_bits,
            boundary_bits=self.boundary_bits, k=lp.k,
            channel_wise=lp.channel_wise, variant=self.variant,
            quantize=self.quantize,
        )

    def dataflow_for(self, name: str) -> str:
        return self.layer(name).dataflow

    # --- decode KV cache (schema v2) ---------------------------------------

    def kv_enabled(self) -> bool:
        """True when the plan quantizes the decode KV cache at all."""
        if self.kv is not None and self.kv.bits is not None:
            return True
        return any(lp.kv_bits is not None for _, lp in self.layers)

    def kv_bits_for(self, name: str) -> Optional[int]:
        """Cache word-length of one cached tensor (``k``, ``v`` or a scoped
        form) through the ``layer()`` lookup; None keeps it bf16."""
        lp = self.layer(name)
        if lp.kv_bits is not None:
            return lp.kv_bits
        return self.kv.bits if self.kv is not None else None

    def kv_store(self) -> str:
        return self.kv.store if self.kv is not None else "packed"

    def kv_slice(self, bits: int) -> int:
        """Digit-plane slice of a cache tensor at ``bits``."""
        return min(bits, self.kv.k if self.kv is not None else 4)

    def distinct_kvbits(self) -> Tuple[int, ...]:
        bits = {lp.kv_bits for _, lp in self.layers
                if lp.kv_bits is not None}
        if self.kv is not None and self.kv.bits is not None:
            bits.add(self.kv.bits)
        return tuple(sorted(bits))

    def validate_kv(self, kv_names: Iterable[str], arch: str = "") -> None:
        """Reject kv word-lengths on layers with no decode cache
        (``kv_names`` is empty for models without one: the CNNs)."""
        if not self.kv_enabled():
            return
        kv_set = set(kv_names)
        if not kv_set:
            raise ValueError(
                f"plan {self.name or '<unnamed>'!r} sets KV-cache "
                f"word-lengths (kv section / kv_bits) but "
                f"{arch or 'this model'} has no decode KV cache; "
                f"remove the kv keys")
        bad = [n for n, lp in self.layers
               if lp.kv_bits is not None and n not in kv_set]
        if bad:
            raise ValueError(
                f"kv_bits set on layers with no KV cache: {bad}; "
                f"cacheable tensors: {sorted(kv_set)}")

    @property
    def layer_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.layers)

    def distinct_wbits(self) -> Tuple[int, ...]:
        bits = {lp.w_bits for _, lp in self.layers} | {self.default.w_bits}
        return tuple(sorted(bits))

    def validate_layers(self, known: Iterable[str]) -> None:
        """Every named layer must exist in the model's workload."""
        known_set = set(known)
        unknown = [n for n, _ in self.layers if n not in known_set]
        if unknown:
            raise ValueError(
                f"plan names layers absent from the model workload: "
                f"{unknown}; known layers: {sorted(known_set)}")

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            # the least version the plan's keys need
            "version": 2 if self.kv_enabled() or self.kv is not None else 1,
            "name": self.name,
            "a_bits": self.a_bits,
            "boundary_bits": self.boundary_bits,
            "variant": self.variant,
            "quantize": self.quantize,
            "default": self.default.to_json(),
            "layers": {n: lp.to_json() for n, lp in self.layers},
        }
        if self.arch:
            out["arch"] = self.arch
        if self.kv is not None:
            out["kv"] = self.kv.to_json()
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, object]) -> "PrecisionPlan":
        if not isinstance(obj, Mapping):
            raise ValueError(f"plan JSON must be an object, got {type(obj)}")
        version = obj.get("version", 2)
        if version not in SUPPORTED_PLAN_VERSIONS:
            raise ValueError(f"unsupported plan version {version}")
        known = {"version", "name", "arch", "a_bits", "boundary_bits",
                 "variant", "quantize", "default", "layers", "kv"}
        extra = set(obj) - known
        if extra:
            raise ValueError(f"unknown plan keys: {sorted(extra)}")
        layers_obj = obj.get("layers", {})
        if not isinstance(layers_obj, Mapping):
            raise ValueError("'layers' must map layer name -> entry")
        entries = list(layers_obj.values()) + [obj.get("default", {})]
        if version < 2 and ("kv" in obj or any(
                isinstance(e, Mapping) and "kv_bits" in e for e in entries)):
            raise ValueError("KV-cache keys (kv, kv_bits) need plan "
                             f"version 2; this file says version {version}")
        kv_obj = obj.get("kv")
        return cls(
            layers=tuple((str(n), LayerPlan.from_json(e))
                         for n, e in layers_obj.items()),
            default=LayerPlan.from_json(obj.get("default", {})),
            a_bits=int(obj.get("a_bits", 8)),
            boundary_bits=int(obj.get("boundary_bits", 8)),
            variant=str(obj.get("variant", "st")),
            quantize=bool(obj.get("quantize", True)),
            name=str(obj.get("name", "")),
            arch=str(obj.get("arch", "")),
            kv=None if kv_obj is None else KVCachePlan.from_json(kv_obj),
        )

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def loads(cls, text: str) -> "PrecisionPlan":
        # json keeps only the last of duplicate object keys; a plan naming
        # one layer twice is a schema error instead.
        return cls.from_json(json.loads(
            text, object_pairs_hook=_reject_duplicate_keys))

    def save(self, path) -> None:
        Path(path).write_text(self.dumps())

    @classmethod
    def load(cls, path) -> "PrecisionPlan":
        return cls.loads(Path(path).read_text())


def _reject_duplicate_keys(pairs):
    """json object_pairs_hook: duplicate keys are a schema error."""
    keys = [k for k, _ in pairs]
    if len(set(keys)) != len(keys):
        dupes = sorted({k for k in keys if keys.count(k) > 1})
        raise ValueError(f"duplicate keys in plan JSON: {dupes}")
    return dict(pairs)


# --- frontier manifests (the serving degradation axis) ----------------------


@dataclasses.dataclass(frozen=True)
class FrontierEntry:
    """One operating point of a serving frontier: its plan, its serve cost
    relative to the accurate point (``rel_latency``, 1.0 at index 0) and
    the planner's accuracy-loss proxy (``error``); ``source`` is the plan
    file's path as the manifest wrote it, or 'inline'."""

    plan: PrecisionPlan
    rel_latency: float = 1.0
    error: float = 0.0
    source: str = "inline"

    @property
    def name(self) -> str:
        return self.plan.name

    def to_json(self) -> Dict[str, object]:
        out: Dict[str, object] = {"rel_latency": self.rel_latency,
                                  "error": self.error}
        out["plan"] = (self.source if self.source != "inline"
                       else self.plan.to_json())
        return out


@dataclasses.dataclass(frozen=True)
class FrontierManifest:
    """N plan points of ONE model, ordered accurate -> fast.

    Each point's ``plan`` is an inline plan object or a path relative to
    the manifest file.  Position 0 is the accurate point; ``error`` must
    not fall and ``rel_latency`` must not rise along the list, every plan
    must target the manifest's ``arch`` (an empty plan ``arch`` inherits
    it), and point names are unique and non-empty.
    """

    name: str
    arch: str
    points: Tuple[FrontierEntry, ...]

    def __post_init__(self):
        if not self.points:
            raise ValueError("a frontier needs at least one plan point")
        if not self.arch:
            raise ValueError("frontier manifests must name their arch")
        names = [e.name for e in self.points]
        if len(set(names)) != len(names):
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate frontier point names: {dupes}")
        if any(not n for n in names):
            raise ValueError("every frontier plan must carry a name")
        for prev, cur in zip(self.points, self.points[1:]):
            if cur.error < prev.error - 1e-12:
                raise ValueError(
                    f"frontier points must be ordered accurate -> fast: "
                    f"error drops from {prev.error} ({prev.name}) to "
                    f"{cur.error} ({cur.name})")
            if cur.rel_latency > prev.rel_latency + 1e-12:
                raise ValueError(
                    f"frontier points must be ordered accurate -> fast: "
                    f"rel_latency rises from {prev.rel_latency} "
                    f"({prev.name}) to {cur.rel_latency} ({cur.name})")
        for e in self.points:
            if e.plan.arch and e.plan.arch != self.arch:
                raise ValueError(
                    f"frontier point {e.name!r} targets arch "
                    f"{e.plan.arch!r}, manifest says {self.arch!r}")

    @property
    def point_names(self) -> Tuple[str, ...]:
        return tuple(e.name for e in self.points)

    def plans(self) -> Tuple[Tuple[str, PrecisionPlan], ...]:
        """(name, plan) pairs in degradation order (accurate first)."""
        return tuple((e.name, e.plan) for e in self.points)

    def validate_layers(self, known: Iterable[str]) -> None:
        known = list(known)
        for e in self.points:
            e.plan.validate_layers(known)

    def to_json(self) -> Dict[str, object]:
        return {"version": FRONTIER_VERSION, "name": self.name,
                "arch": self.arch,
                "points": [e.to_json() for e in self.points]}

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"

    def save(self, path) -> None:
        Path(path).write_text(self.dumps())

    @classmethod
    def from_json(cls, obj: Mapping[str, object],
                  base_dir: Optional[Path] = None) -> "FrontierManifest":
        if not isinstance(obj, Mapping):
            raise ValueError(
                f"frontier JSON must be an object, got {type(obj)}")
        version = obj.get("version", FRONTIER_VERSION)
        if version != FRONTIER_VERSION:
            raise ValueError(f"unsupported frontier version {version}")
        extra = set(obj) - {"version", "name", "arch", "points"}
        if extra:
            raise ValueError(f"unknown frontier keys: {sorted(extra)}")
        pts_obj = obj.get("points", [])
        if not isinstance(pts_obj, Sequence) or isinstance(pts_obj, str):
            raise ValueError("'points' must be a list of frontier entries")
        entries = []
        for i, p in enumerate(pts_obj):
            if not isinstance(p, Mapping):
                raise ValueError(f"frontier point {i} must be an object")
            p_extra = set(p) - {"plan", "rel_latency", "error"}
            if p_extra:
                raise ValueError(
                    f"unknown keys in frontier point {i}: {sorted(p_extra)}")
            plan_ref = p.get("plan")
            if isinstance(plan_ref, str):
                path = Path(plan_ref)
                if not path.is_absolute():
                    path = (base_dir or Path(".")) / path
                plan, source = PrecisionPlan.load(path), str(plan_ref)
            elif isinstance(plan_ref, Mapping):
                plan, source = PrecisionPlan.from_json(plan_ref), "inline"
            else:
                raise ValueError(
                    f"frontier point {i}: 'plan' must be a plan object or "
                    f"a path string, got {type(plan_ref)}")
            entries.append(FrontierEntry(
                plan=plan, rel_latency=float(p.get("rel_latency", 1.0)),
                error=float(p.get("error", 0.0)), source=source))
        return cls(name=str(obj.get("name", "")),
                   arch=str(obj.get("arch", "")), points=tuple(entries))

    @classmethod
    def loads(cls, text: str,
              base_dir: Optional[Path] = None) -> "FrontierManifest":
        return cls.from_json(
            json.loads(text, object_pairs_hook=_reject_duplicate_keys),
            base_dir=base_dir)

    @classmethod
    def load(cls, path) -> "FrontierManifest":
        path = Path(path)
        return cls.loads(path.read_text(), base_dir=path.parent)


def as_plan(policy: PolicyOrPlan, name: str = "") -> PrecisionPlan:
    """Uniform policy -> its degenerate plan; a plan passes through."""
    if isinstance(policy, PrecisionPlan):
        return policy
    return PrecisionPlan.uniform(policy, name=name)


def resolve_policy(policy: PolicyOrPlan, layer_name: str) -> PrecisionPolicy:
    """The per-layer ``PrecisionPolicy`` a kernel call should use."""
    if isinstance(policy, PrecisionPlan):
        return policy.policy_for(layer_name)
    return policy


def resolve_dataflow(policy: PolicyOrPlan, layer_name: str,
                     dataflow: str = "auto") -> str:
    """Per-layer conv dataflow: an explicit non-'auto' argument wins, else
    the plan's per-layer entry, else 'auto'."""
    if dataflow != "auto":
        return dataflow
    if isinstance(policy, PrecisionPlan):
        return policy.dataflow_for(layer_name)
    return "auto"


def resolve_kv_bits(policy: PolicyOrPlan, layer_name: str) -> Optional[int]:
    """Cache word-length of one cached tensor; uniform policies and plans
    without kv keys resolve to None (a bf16 cache)."""
    if isinstance(policy, PrecisionPlan):
        return policy.kv_bits_for(layer_name)
    return None


def strip_kv(policy: PolicyOrPlan) -> PolicyOrPlan:
    """The same plan with its KV-cache keys removed (a bf16 cache); the
    weight formats, and so a packed tree, stay valid."""
    if not isinstance(policy, PrecisionPlan) or not policy.kv_enabled():
        return policy
    layers = tuple((n, dataclasses.replace(lp, kv_bits=None))
                   for n, lp in policy.layers)
    return dataclasses.replace(policy, layers=layers, kv=None)


# --- footprint accounting (Table III, per layer) -----------------------------


def kv_cache_token_bytes(bits: Optional[int], heads: int, head_dim: int,
                         slice_k: int = 4) -> float:
    """Bytes ONE token of one cached K or V tensor occupies: bf16 rows at
    ``bits=None``, else ``ceil(head_dim * bits / 8)`` code bytes (digit
    planes pack densely) plus 4 bytes of bf16 scale and zero, per head."""
    if bits is None:
        return heads * head_dim * 2.0
    k = min(bits, slice_k)
    planes = -(-bits // k)
    packed_d = -(-head_dim // (8 // k))
    return float(heads * (planes * packed_d + 4))


def plan_footprint_report(
    layer_params: Mapping[str, int],
    layer_classes: Mapping[str, str],
    plan: PolicyOrPlan,
    *,
    kv_layers: Optional[Mapping[str, Tuple[int, int]]] = None,
    kv_tokens: int = 0,
) -> Dict[str, float]:
    """Table III accounting at per-layer word-lengths.

    ``layer_params`` maps layer name -> weight count, ``layer_classes``
    name -> 'inner' | 'boundary'; ``kv_layers`` (cached tensor -> (kv
    heads, head_dim)) adds the decode cache at ``kv_tokens`` tokens a
    sequence (``kv_*`` and ``total_*`` keys).  The fp baseline counts 32
    bits a weight, as the reference does.
    """
    p = as_plan(plan)
    if p.kv_enabled() and not kv_layers:
        raise ValueError(
            f"plan {p.name or '<unnamed>'!r} sets KV-cache word-lengths "
            f"but this workload has no KV cache (pass kv_layers for "
            f"models with a decode cache; CNN plans must not carry kv "
            f"keys)")
    fp_bytes = 4.0 * sum(layer_params.values())
    q_bytes = 0.0
    n_inner = n_bound = 0
    for name, count in layer_params.items():
        cls = layer_classes.get(name, "inner")
        pol = p.policy_for(name)
        bits = pol.bits_for(cls) if p.quantize else 32
        q_bytes += count * bits / 8.0
        if cls == "boundary":
            n_bound += count
        else:
            n_inner += count
    out = {
        "fp32_bytes": fp_bytes,
        "quant_bytes": q_bytes,
        "compression": fp_bytes / max(q_bytes, 1.0),
        "inner_params": float(n_inner),
        "boundary_params": float(n_bound),
    }
    if kv_layers:
        tokens = max(int(kv_tokens), 1)
        kv_fp = kv_q = 0.0
        for name, (heads, head_dim) in kv_layers.items():
            bits = p.kv_bits_for(name)
            kv_fp += tokens * kv_cache_token_bytes(None, heads, head_dim)
            kv_q += tokens * kv_cache_token_bytes(
                bits, heads, head_dim, p.kv_slice(bits or 8))
        out.update({
            "kv_tokens": float(tokens),
            "kv_fp16_bytes": kv_fp,
            "kv_quant_bytes": kv_q,
            "kv_compression": kv_fp / max(kv_q, 1.0),
            "total_fp_bytes": fp_bytes + kv_fp,
            "total_quant_bytes": q_bytes + kv_q,
        })
    return out


# --- schema validation CLI ---------------------------------------------------


def validate_plan_json(path, arch: Optional[str] = None) -> PrecisionPlan:
    """Load and schema-check a plan file; with ``arch`` (or the plan's own
    ``arch`` key) also check every named layer and ``kv_bits`` against
    that architecture.  An arch outside the port's registry raises
    ``KeyError``."""
    plan = PrecisionPlan.load(path)
    arch = arch or plan.arch or None
    if arch is not None:
        from repro_torch import configs  # configs imports the model modules
        api = configs.get(arch)
        plan.validate_layers(api.plan_layer_names())
        plan.validate_kv(api.kv_layer_names(), arch=arch)
    return plan


def validate_frontier_json(path) -> FrontierManifest:
    """Load and schema-check a frontier manifest, and check every point's
    layer names against the manifest's arch."""
    manifest = FrontierManifest.load(path)
    from repro_torch import configs
    api = configs.get(manifest.arch)
    manifest.validate_layers(api.plan_layer_names())
    return manifest


def _unknown_arch(kind: str, arch: str, where: str) -> str:
    from repro_torch import configs
    return (f"[{kind}] unknown arch {arch!r}{where}; available: "
            f"{', '.join(configs.ARCH_NAMES)}")


def _main_validate_frontier(paths: Sequence[str]) -> int:
    rc = 0
    for path in paths:
        try:
            manifest = validate_frontier_json(path)
        except KeyError:
            arch = FrontierManifest.load(path).arch
            print(_unknown_arch("frontier", arch, f" in {path}"),
                  file=sys.stderr)
            rc = 2
            continue
        except (ValueError, OSError, json.JSONDecodeError) as e:
            print(f"[frontier] INVALID {path}: {e}", file=sys.stderr)
            rc = max(rc, 1)
            continue
        pts = ", ".join(
            f"{e.name}(w{'/'.join(map(str, e.plan.distinct_wbits()))}"
            f"@{e.rel_latency:g})" for e in manifest.points)
        print(f"[frontier] ok {path}: arch {manifest.arch}, "
              f"{len(manifest.points)} points accurate->fast: {pts}")
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``python -m repro_torch.core.plan validate|validate-frontier
    PATHS``: exit 0 when every file is valid, 1 on a schema or layer
    error, 2 on an unknown arch."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.plan",
        description="Validate precision-plan JSON files (schema + the "
                    "arch's layer names; the arch comes from --arch or "
                    "each plan's 'arch' key) or frontier manifests "
                    "(validate-frontier: ordering, arch agreement, every "
                    "point's layer names).")
    ap.add_argument("command", choices=["validate", "validate-frontier"])
    ap.add_argument("paths", nargs="+",
                    help="plan (or frontier-manifest) JSON files")
    ap.add_argument("--arch", default=None,
                    help="check layer names against this arch's workload "
                         "(overrides the plans' own arch)")
    ap.add_argument("--schema-only", action="store_true",
                    help="allow plans with no arch (schema check only)")
    args = ap.parse_args(argv)
    if args.command == "validate-frontier":
        return _main_validate_frontier(args.paths)
    from repro_torch import configs
    if args.arch is not None and args.arch not in configs.ARCH_NAMES:
        print(_unknown_arch("plan", args.arch, ""), file=sys.stderr)
        return 2
    rc = 0
    for path in args.paths:
        try:
            plan = validate_plan_json(path, arch=args.arch)
            if not (args.arch or plan.arch) and not args.schema_only:
                print(f"[plan] INVALID {path}: no arch to validate layer "
                      f"names against (embed an 'arch' key, pass --arch, "
                      f"or pass --schema-only)", file=sys.stderr)
                rc = 1
                continue
        except KeyError:
            plan_arch = PrecisionPlan.load(path).arch
            print(_unknown_arch("plan", plan_arch, f" in {path}"),
                  file=sys.stderr)
            rc = 2
            continue
        except (ValueError, OSError, json.JSONDecodeError) as e:
            print(f"[plan] INVALID {path}: {e}", file=sys.stderr)
            rc = max(rc, 1)
            continue
        print(f"[plan] ok {path}: {len(plan.layers)} named layers, "
              f"w_bits {plan.distinct_wbits()}, default "
              f"w{plan.default.w_bits}k{plan.default.k}"
              + (f", kv_bits {plan.distinct_kvbits()} "
                 f"({plan.kv_store()})" if plan.kv_enabled() else "")
              + (f", arch {args.arch or plan.arch}"
                 if (args.arch or plan.arch) else ""))
    return rc


if __name__ == "__main__":
    sys.exit(main())

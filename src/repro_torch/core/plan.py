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

Schema v2 adds the decode KV cache: the plan-level ``kv`` section sets the
cache-wide word-length, slice and store ('packed' digit planes or the
'qdq' bf16 oracle layout), and ``kv_bits`` on a ``k``/``v`` entry (or a
scoped ``l{i}.k``) overrides it through the same lookup.  A version-1
file carrying kv keys is refused.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

from repro_torch.core.precision import (PrecisionPolicy, VALID_SLICES,
                                        VALID_WBITS)

__all__ = [
    "LayerPlan",
    "KVCachePlan",
    "PrecisionPlan",
    "resolve_policy",
    "resolve_dataflow",
    "resolve_kv_bits",
    "strip_kv",
    "validate_plan_json",
    "VALID_KV_BITS",
]

SUPPORTED_PLAN_VERSIONS = (1, 2)
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


def validate_plan_json(path, arch: Optional[str] = None) -> PrecisionPlan:
    """Load and schema-check a plan file; with ``arch`` (or the plan's own
    ``arch`` key) also check every named layer against that architecture.
    An arch outside the registry raises ``KeyError``."""
    plan = PrecisionPlan.load(path)
    arch = arch or plan.arch or None
    if arch is not None:
        from repro_torch import configs  # configs imports the model modules
        api = configs.get(arch)
        plan.validate_layers(api.plan_layer_names())
        bad = [n for n, lp in plan.layers if lp.kv_bits is not None
               and n not in set(api.kv_layer_names())]
        if bad:
            raise ValueError(f"kv_bits set on layers with no KV cache: {bad}")
    return plan

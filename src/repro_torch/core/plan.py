"""Layer-wise precision plans: one (w_Q, k, channel_wise, dataflow) per layer.

Port of the serving half of ``repro.core.plan``.  The JSON schema is the
JAX package's, so the port reads ``examples/plans/*.json`` in place:

    {
      "version": 1,
      "a_bits": 8, "variant": "st",
      "default": {"w_bits": 8, "k": 4, "channel_wise": false,
                  "dataflow": "auto"},
      "layers": {"s0b0c1": {"w_bits": 2, "k": 2}, ...}
    }

Layer names are the model's ``gemm_workload`` names.  Resolution is
hierarchical: an exact entry wins, else scope prefixes are stripped one
at a time (``l3.q`` falls back to ``q``), else the plan default applies.
Boundary layers stay pinned through ``PrecisionPolicy.bits_for``.

The decode KV-cache keys of schema v2 (``kv``, ``kv_bits``) belong to the
LM decode path, which the port does not serve yet: a plan carrying them
is refused rather than silently served without its cache format.
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
    "PrecisionPlan",
    "resolve_policy",
    "resolve_dataflow",
    "validate_plan_json",
]

SUPPORTED_PLAN_VERSIONS = (1, 2)
VALID_DATAFLOWS = ("auto", "im2col", "implicit")

PolicyOrPlan = Union[PrecisionPolicy, "PrecisionPlan"]


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's deployment format."""

    w_bits: int = 8
    k: int = 4
    channel_wise: bool = False
    dataflow: str = "auto"

    def __post_init__(self):
        if self.w_bits not in VALID_WBITS:
            raise ValueError(f"w_bits must be in {VALID_WBITS}, "
                             f"got {self.w_bits}")
        if self.k not in VALID_SLICES:
            raise ValueError(f"k must be in {VALID_SLICES}, got {self.k}")
        if self.dataflow not in VALID_DATAFLOWS:
            raise ValueError(f"dataflow must be in {VALID_DATAFLOWS}, "
                             f"got {self.dataflow!r}")

    def to_json(self) -> Dict[str, object]:
        return {"w_bits": self.w_bits, "k": self.k,
                "channel_wise": self.channel_wise, "dataflow": self.dataflow}

    @classmethod
    def from_json(cls, obj: Mapping[str, object]) -> "LayerPlan":
        if "kv_bits" in obj:
            raise ValueError("kv_bits (decode KV-cache word-length) is not "
                             "served by the port yet")
        extra = set(obj) - {"w_bits", "k", "channel_wise", "dataflow"}
        if extra:
            raise ValueError(f"unknown layer-plan keys: {sorted(extra)}")
        return cls(
            w_bits=int(obj.get("w_bits", 8)),
            k=int(obj.get("k", 4)),
            channel_wise=bool(obj.get("channel_wise", False)),
            dataflow=str(obj.get("dataflow", "auto")),
        )


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

    def __post_init__(self):
        if self.variant not in ("st", "sa"):
            raise ValueError("variant must be 'st' or 'sa'")
        if self.boundary_bits not in VALID_WBITS:
            raise ValueError(f"boundary_bits must be in {VALID_WBITS}")
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
            "version": 1,
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
        return out

    @classmethod
    def from_json(cls, obj: Mapping[str, object]) -> "PrecisionPlan":
        if not isinstance(obj, Mapping):
            raise ValueError(f"plan JSON must be an object, got {type(obj)}")
        version = obj.get("version", 1)
        if version not in SUPPORTED_PLAN_VERSIONS:
            raise ValueError(f"unsupported plan version {version}")
        if "kv" in obj:
            raise ValueError("the 'kv' section (decode KV-cache format) is "
                             "not served by the port yet")
        known = {"version", "name", "arch", "a_bits", "boundary_bits",
                 "variant", "quantize", "default", "layers"}
        extra = set(obj) - known
        if extra:
            raise ValueError(f"unknown plan keys: {sorted(extra)}")
        layers_obj = obj.get("layers", {})
        if not isinstance(layers_obj, Mapping):
            raise ValueError("'layers' must map layer name -> entry")
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


def validate_plan_json(path, arch: Optional[str] = None) -> PrecisionPlan:
    """Load and schema-check a plan file; with ``arch`` (or the plan's own
    ``arch`` key) also check every named layer against that architecture.
    An arch outside the registry raises ``KeyError``."""
    plan = PrecisionPlan.load(path)
    arch = arch or plan.arch or None
    if arch is not None:
        from repro_torch import configs  # configs imports the model modules
        plan.validate_layers(configs.get(arch).plan_layer_names())
    return plan

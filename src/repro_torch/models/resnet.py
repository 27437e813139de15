"""Quantized ResNet-18/50/152 (port of ``repro.models.resnet``): QAT
training and packed serving.

``apply_with_state`` is the QAT forward with BatchNorm on batch statistics
(``training=True``: the biased variance, running statistics updated with
momentum 0.9) or on the running ones; ``forward`` is its logits-only
facade.  Plain torch under autograd: the reference's train path reaches no
Pallas kernel.  The stem's 3x3/2 max pool passes its gradient to the first
maximum of each window in row-major order, as XLA's ``select_and_scatter``
does (windows of post-ReLU zeros are common).

``pack_for_serve`` turns a QAT parameter tree and BN running statistics
into packed digit planes with every BatchNorm folded into the (scale,
shift) of the conv before it; ``serve_forward`` runs the packed network
with BN, the shortcut add and ReLU in the kernel epilogues.  The stem and
classifier are boundary layers (``boundary_bits``); every inner conv runs
at its own plan-resolved format.  Layout is NHWC throughout, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import plan as plan_lib
from repro_torch.core.dse import Gemm
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.device import resolve_device
from repro_torch.kernels.mpmm import ref as mpmm_ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.nn import layers as nnl
from repro_torch.nn import quantized as Q
from repro_torch.nn.param import ParamSpec

__all__ = ["ResNetConfig", "RESNET_STAGES", "specs", "init_bn_state",
           "bn_apply", "apply_with_state", "forward", "pack_for_serve", "serve_features", "serve_forward",
           "gemm_workload", "plan_layer_names", "param_counts",
           "layer_param_counts", "layer_classes", "inner_layer_names",
           "layer_weights", "model_flops", "total_params", "active_params"]

RESNET_STAGES = {
    18: ("basic", (2, 2, 2, 2)),
    50: ("bottleneck", (3, 4, 6, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depth: int
    n_classes: int = 1000
    img_size: int = 224
    width: int = 64
    # Truncated-depth variants: overrides the per-depth stage table.
    stages_override: Optional[Tuple[int, ...]] = None

    @property
    def block(self) -> str:
        return RESNET_STAGES[self.depth][0]

    @property
    def stages(self) -> Tuple[int, ...]:
        return self.stages_override or RESNET_STAGES[self.depth][1]

    @property
    def expansion(self) -> int:
        return 4 if self.block == "bottleneck" else 1

    @property
    def fc_in(self) -> int:
        """Channels entering the classifier."""
        return self.width * 2 ** (len(self.stages) - 1) * self.expansion


# --- specs ------------------------------------------------------------------


def bn_spec(c: int) -> Dict:
    return {"scale": ParamSpec(shape=(c,), axes=("act_embed",), init="ones"),
            "bias": ParamSpec(shape=(c,), axes=("act_embed",),
                              init="zeros")}


def init_bn_state(specs_tree, device="cuda"):
    """Running-stats state tree parallel to every bn param subtree, on
    ``device`` (CUDA by default; raises without a card unless
    ``device="cpu"``)."""
    device = resolve_device(device)
    out = {}
    for k, v in specs_tree.items():
        if isinstance(v, dict):
            if "scale" in v and "bias" in v and len(v) == 2:
                c = v["scale"].shape[0]
                out[k] = {"mean": torch.zeros(c, device=device),
                          "var": torch.ones(c, device=device)}
            else:
                sub = init_bn_state(v, device)
                if sub:
                    out[k] = sub
    return out


def _qc(cin, cout, k, policy, name, layer_class="inner"):
    return Q.qconv_spec(
        cin, cout, k, layer_class=layer_class, name=name,
        channel_wise=plan_lib.resolve_policy(policy, name).channel_wise)


def _basic_spec(cin, cout, stride, policy, lname):
    s = {"conv1": _qc(cin, cout, 3, policy, lname + "c1"),
         "bn1": bn_spec(cout),
         "conv2": _qc(cout, cout, 3, policy, lname + "c2"),
         "bn2": bn_spec(cout)}
    if stride != 1 or cin != cout:
        s["proj"] = _qc(cin, cout, 1, policy, lname + "p")
        s["bn_proj"] = bn_spec(cout)
    return s


def _bottleneck_spec(cin, cmid, stride, policy, lname):
    cout = 4 * cmid
    s = {"conv1": _qc(cin, cmid, 1, policy, lname + "c1"),
         "bn1": bn_spec(cmid),
         "conv2": _qc(cmid, cmid, 3, policy, lname + "c2"),
         "bn2": bn_spec(cmid),
         "conv3": _qc(cmid, cout, 1, policy, lname + "c3"),
         "bn3": bn_spec(cout)}
    if stride != 1 or cin != cout:
        s["proj"] = _qc(cin, cout, 1, policy, lname + "p")
        s["bn_proj"] = bn_spec(cout)
    return s


def _block_channels(cfg: ResNetConfig) -> Iterator[Tuple[int, int, int, int, int]]:
    """Yield (stage, block, cin, cmid/cout, stride)."""
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stages):
        cmid = cfg.width * (2 ** si)
        for bi in range(n_blocks):
            stride = 2 if (bi == 0 and si > 0) else 1
            yield si, bi, cin, cmid, stride
            cin = cmid * cfg.expansion


def specs(cfg: ResNetConfig, mode: str = "train",
          policy=PrecisionPolicy()) -> Dict:
    """The QAT parameter spec tree (serving packs it offline)."""
    del mode
    tree: Dict = {
        "stem": _qc(3, cfg.width, 7, policy, "stem", layer_class="boundary"),
        "bn_stem": bn_spec(cfg.width),
        "fc": Q.qlinear_spec(
            cfg.fc_in, cfg.n_classes, axes=("embed", "vocab"),
            layer_class="boundary", name="fc",
            channel_wise=plan_lib.resolve_policy(policy, "fc").channel_wise),
    }
    mk = _bottleneck_spec if cfg.block == "bottleneck" else _basic_spec
    for si, bi, cin, cmid, stride in _block_channels(cfg):
        key = f"s{si}b{bi}"
        tree[key] = mk(cin, cmid, stride, policy, key)
    return tree


# --- QAT forward ------------------------------------------------------------


def bn_apply(p, state, x: torch.Tensor, *, training: bool):
    """BatchNorm over (B, H, W) in f32 -> (y in x's dtype, new state).
    Training normalizes by the batch mean and biased variance (jnp.var's
    two passes: the mean, then the mean of squared deviations) and moves
    the running statistics toward them with momentum 0.9 (no gradient
    through the state)."""
    xf = x.to(torch.float32)
    if training:
        n = xf.shape[0] * xf.shape[1] * xf.shape[2]
        mean = xf.sum(dim=(0, 1, 2)) / n
        var = torch.square(xf - mean).sum(dim=(0, 1, 2)) / n
        new_state = {
            "mean": 0.9 * state["mean"] + (1 - 0.9) * mean.detach(),
            "var": 0.9 * state["var"] + (1 - 0.9) * var.detach(),
        }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype), new_state


def _conv_bn(p, st, conv, bn, x, policy, *, k, stride=1, training, name,
             mesh=None, **kw):
    """Conv ``p[conv]`` then BN ``p[bn]`` -> (y, BN state).  On a
    tensor-parallel ``mesh`` the conv is column-parallel over its output
    channels and all-gathered before the BN
    (``nn.quantized.qconv_apply``), so BN and its batch statistics run
    whole on every rank."""
    h = Q.qconv_apply(p[conv], x, policy, k=k, stride=stride, name=name,
                      mesh=mesh, cout=p[bn]["scale"].shape[0], **kw)
    return bn_apply(p[bn], st[bn], h, training=training)


def _shortcut_train(p, st, x, policy, stride, training, lname, mesh,
                    new_st):
    if "proj" not in p:
        return x
    x, new_st["bn_proj"] = _conv_bn(p, st, "proj", "bn_proj", x, policy,
                                    k=1, stride=stride, training=training,
                                    name=lname + "p", mesh=mesh)
    return x


def _basic_fwd(p, st, x, policy, stride, training, lname, mesh=None):
    kw = dict(policy=policy, training=training, mesh=mesh)
    h, st1 = _conv_bn(p, st, "conv1", "bn1", x, k=3, stride=stride,
                      name=lname + "c1", **kw)
    h, st2 = _conv_bn(p, st, "conv2", "bn2", torch.relu(h), k=3,
                      name=lname + "c2", **kw)
    new_st = {"bn1": st1, "bn2": st2}
    x = _shortcut_train(p, st, x, policy, stride, training, lname, mesh,
                        new_st)
    return torch.relu(x + h), new_st


def _bottleneck_fwd(p, st, x, policy, stride, training, lname, mesh=None):
    kw = dict(policy=policy, training=training, mesh=mesh)
    h, st1 = _conv_bn(p, st, "conv1", "bn1", x, k=1, name=lname + "c1",
                      **kw)
    h, st2 = _conv_bn(p, st, "conv2", "bn2", torch.relu(h), k=3,
                      stride=stride, name=lname + "c2", **kw)
    h, st3 = _conv_bn(p, st, "conv3", "bn3", torch.relu(h), k=1,
                      name=lname + "c3", **kw)
    new_st = {"bn1": st1, "bn2": st2, "bn3": st3}
    x = _shortcut_train(p, st, x, policy, stride, training, lname, mesh,
                        new_st)
    return torch.relu(x + h), new_st


def apply_with_state(cfg: ResNetConfig, params, state, images: torch.Tensor,
                     policy, *, training: bool = False, mesh=None):
    """QAT forward: images (B, H, W, 3) -> (logits (B, classes) bf16, new
    BN state).  The stem quantizes its weights but not the raw pixels.

    ``mesh`` with a 'model' axis above 1 (tensor-parallel training):
    ``params`` holds the rank's 'model' blocks under ``TRAIN_RULES``.
    Every conv is column-parallel over its output channels, which are
    all-gathered before its BN (BN, its state and the residual stream
    whole on every rank); the classifier is column-parallel over the
    classes and returns the rank's ``nn.layers.VocabShard`` for the
    vocabulary-parallel loss.  A leaf kept whole (its channels or classes
    do not split) runs as on one device."""
    if mesh_lib.model_coords(mesh)[1] == 1:
        mesh = None
    x, st_stem = _conv_bn(params, state, "stem", "bn_stem", images, policy,
                          k=7, stride=2, training=training, name="stem",
                          mesh=mesh, layer_class="boundary",
                          quantize_act=False)
    x = max_pool_same(torch.relu(x))
    new_state = {"bn_stem": st_stem}
    fwd = _bottleneck_fwd if cfg.block == "bottleneck" else _basic_fwd
    for si, bi, cin, cmid, stride in _block_channels(cfg):
        key = f"s{si}b{bi}"
        x, new_state[key] = fwd(params[key], state[key], x, policy, stride,
                                training, key, mesh)
    # jnp.mean on bf16 sums in f32 and returns bf16
    x = x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)
    fc = {k: v for k, v in params["fc"].items() if k != Q.QMARK}
    n = fc["w"].shape[-1]
    cut = mesh is not None and n != cfg.n_classes
    logits = Q.qlinear_apply(fc, x, policy, layer_class="boundary",
                             name="fc", col_mesh=mesh if cut else None)
    if cut:
        logits = nnl.VocabShard(logits, mesh,
                                mesh_lib.model_coords(mesh)[0] * n,
                                cfg.n_classes)
    return logits, new_state


def forward(cfg: ResNetConfig, params, images: torch.Tensor, policy, *,
            mode: str = "train", impl: str = "auto", state=None, mesh=None):
    """Logits only: batch statistics under ``mode="train"``, else the
    running ones of ``state`` (a fresh state, zeros and ones, on the
    images' device when none is given).  ``impl`` is unused: the QAT
    forward runs no kernel.  ``mesh``: tensor-parallel training
    (``apply_with_state``)."""
    del impl
    if state is None:
        state = init_bn_state(specs(cfg), device=images.device)
    logits, _ = apply_with_state(cfg, params, state, images, policy,
                                 training=(mode == "train"), mesh=mesh)
    return logits


# --- packed serve path --------------------------------------------------------


def _fold_bn(bn_params, bn_state, eps: float = 1e-5):
    """Inference BN -> (scale, shift) f32 (1, C) for the kernel epilogue."""
    g = bn_params["scale"].to(torch.float32)
    b = bn_params["bias"].to(torch.float32)
    mean = bn_state["mean"].to(torch.float32)
    var = bn_state["var"].to(torch.float32)
    s = g * torch.rsqrt(var + eps)
    t = b - mean * s
    c = s.shape[-1]
    return s.reshape(1, c), t.reshape(1, c)


def pack_for_serve(cfg: ResNetConfig, params, state, policy):
    """QAT tree + BN running stats -> deployed serve tree: packed planes per
    layer at its own plan format, every BN folded to (scale, shift)."""
    if isinstance(policy, plan_lib.PrecisionPlan):
        policy.validate_layers(plan_layer_names(cfg))
    sp = specs(cfg, policy=policy)
    packed = Q.pack_tree(params, sp, policy)
    out = {}
    for key, sub in packed.items():
        if key.startswith("bn"):
            out[key] = _fold_bn(params[key], state[key])
        elif Q.is_qlinear(sp[key]):
            out[key] = sub
        else:  # residual block: fold its BNs, keep the packed convs
            out[key] = {n: (_fold_bn(params[key][n], state[key][n])
                            if n.startswith("bn") else v)
                        for n, v in sub.items()}
    return out


def _shortcut(p, x, policy, stride, impl, tile, dataflow, lname):
    """Identity or projection shortcut (projection: conv + folded BN)."""
    if "proj" not in p:
        return x
    s, t = p["bn_proj"]
    return Q.qconv_serve_apply(
        p["proj"], x, policy, k=1, stride=stride, impl=impl, tile=tile,
        epilogue=Q.EpilogueSpec(bn=True), scale=s, shift=t,
        dataflow=dataflow, name=lname + "p")


def _basic_serve(p, x, policy, stride, impl, tile, dataflow, lname):
    sc = _shortcut(p, x, policy, stride, impl, tile, dataflow, lname)
    s1, t1 = p["bn1"]
    h = Q.qconv_serve_apply(
        p["conv1"], x, policy, k=3, stride=stride, impl=impl, tile=tile,
        epilogue=Q.EpilogueSpec(bn=True, relu=True), scale=s1, shift=t1,
        dataflow=dataflow, name=lname + "c1")
    s2, t2 = p["bn2"]
    # conv2 carries BN2 + shortcut add + final ReLU in one epilogue.
    return Q.qconv_serve_apply(
        p["conv2"], h, policy, k=3, impl=impl, tile=tile,
        epilogue=Q.EpilogueSpec(bn=True, residual=True, relu=True),
        scale=s2, shift=t2, residual=sc, dataflow=dataflow,
        name=lname + "c2")


def _bottleneck_serve(p, x, policy, stride, impl, tile, dataflow, lname):
    sc = _shortcut(p, x, policy, stride, impl, tile, dataflow, lname)
    s1, t1 = p["bn1"]
    h = Q.qconv_serve_apply(
        p["conv1"], x, policy, k=1, impl=impl, tile=tile,
        epilogue=Q.EpilogueSpec(bn=True, relu=True), scale=s1, shift=t1,
        dataflow=dataflow, name=lname + "c1")
    s2, t2 = p["bn2"]
    h = Q.qconv_serve_apply(
        p["conv2"], h, policy, k=3, stride=stride, impl=impl, tile=tile,
        epilogue=Q.EpilogueSpec(bn=True, relu=True), scale=s2, shift=t2,
        dataflow=dataflow, name=lname + "c2")
    s3, t3 = p["bn3"]
    return Q.qconv_serve_apply(
        p["conv3"], h, policy, k=1, impl=impl, tile=tile,
        epilogue=Q.EpilogueSpec(bn=True, residual=True, relu=True),
        scale=s3, shift=t3, residual=sc, dataflow=dataflow,
        name=lname + "c3")


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """NHWC max-pool with XLA's SAME pads (odd pixel on the high side)
    filled with -inf, as ``lax.reduce_window(..., -inf, max, ..., 'SAME')``.
    A tap replaces the running maximum only where it is strictly greater,
    so the gradient goes to the first maximum of a window in row-major
    order, where XLA's ``select_and_scatter`` sends it (``torch.maximum``
    would split it between ties)."""
    _, h, w, _ = x.shape
    ph = mpmm_ref.same_pads(h, window, stride, "SAME")
    pw = mpmm_ref.same_pads(w, window, stride, "SAME")
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    ho = (xp.shape[1] - window) // stride + 1
    wo = (xp.shape[2] - window) // stride + 1
    out = None
    for i in range(window):
        for j in range(window):
            v = xp[:, i:i + (ho - 1) * stride + 1:stride,
                   j:j + (wo - 1) * stride + 1:stride, :]
            out = v if out is None else torch.where(v > out, v, out)
    return out


def serve_features(cfg: ResNetConfig, packed, images: torch.Tensor, policy,
                   *, impl: str = "auto", tile=None,
                   dataflow: str = "auto") -> torch.Tensor:
    """Packed network up to the classifier: (B, H, W, 3) float images ->
    mean-pooled (B, fc_in) bf16 features."""
    s, t = packed["bn_stem"]
    # The stem sees raw pixels that straddle zero: symmetric signed codes.
    x = Q.qconv_serve_apply(
        packed["stem"], images, policy, k=7, stride=2,
        layer_class="boundary", impl=impl, tile=tile, act_signed=True,
        epilogue=Q.EpilogueSpec(bn=True, relu=True), scale=s, shift=t,
        dataflow=dataflow, name="stem")
    x = max_pool_same(x)
    fwd = _bottleneck_serve if cfg.block == "bottleneck" else _basic_serve
    for si, bi, cin, cmid, stride in _block_channels(cfg):
        key = f"s{si}b{bi}"
        x = fwd(packed[key], x, policy, stride, impl, tile, dataflow, key)
    # jnp.mean on bf16 sums in f32 and returns bf16.
    return x.to(torch.float32).mean(dim=(1, 2)).to(x.dtype)


def serve_forward(cfg: ResNetConfig, packed, images: torch.Tensor, policy, *,
                  impl: str = "auto", tile=None,
                  dataflow: str = "auto") -> torch.Tensor:
    """Deployed forward over a ``pack_for_serve`` tree -> (B, classes) bf16.

    Runs on the device of ``images`` and ``packed``: CUDA tensors go through
    the hand-written kernels (``impl='auto'``), CPU tensors through their
    plain versions.  ``policy`` may be a ``PrecisionPlan``; each layer then
    resolves its own format and dataflow, and an explicit non-'auto'
    ``dataflow`` pins every conv.
    """
    x = serve_features(cfg, packed, images, policy, impl=impl, tile=tile,
                       dataflow=dataflow)
    return Q.qlinear_serve_apply(packed["fc"], x, policy,
                                 layer_class="boundary", impl=impl,
                                 tile=tile, name="fc")


def gemm_workload(cfg: ResNetConfig, batch: int = 1) -> List[Gemm]:
    """Conv layers as GEMMs at the config's image size (the DSE's and the
    planner's input)."""
    hw = cfg.img_size // 2  # stem stride 2
    gemms = [Gemm("stem", batch * hw * hw, 3 * 49, cfg.width,
                  layer_class="boundary")]
    hw = hw // 2  # maxpool
    for si, bi, cin, cmid, stride in _block_channels(cfg):
        hw_out = hw // stride if stride > 1 else hw
        m = batch * hw_out * hw_out
        if cfg.block == "bottleneck":
            gemms += [Gemm(f"s{si}b{bi}c1", batch * hw * hw, cin, cmid),
                      Gemm(f"s{si}b{bi}c2", m, 9 * cmid, cmid),
                      Gemm(f"s{si}b{bi}c3", m, cmid, 4 * cmid)]
            if stride != 1 or cin != 4 * cmid:
                gemms.append(Gemm(f"s{si}b{bi}p", m, cin, 4 * cmid))
        else:
            gemms += [Gemm(f"s{si}b{bi}c1", m, 9 * cin, cmid),
                      Gemm(f"s{si}b{bi}c2", m, 9 * cmid, cmid)]
            if stride != 1 or cin != cmid:
                gemms.append(Gemm(f"s{si}b{bi}p", m, cin, cmid))
        hw = hw_out
    gemms.append(Gemm("fc", batch, cfg.fc_in, cfg.n_classes,
                      layer_class="boundary"))
    return gemms


def plan_layer_names(cfg: ResNetConfig) -> List[str]:
    """The plan namespace: the workload layer names."""
    return [g.name for g in gemm_workload(cfg, batch=1)]


# Param-tree key of each conv of a block -> its workload-name suffix.
_PLAN_SUFFIX = {"conv1": "c1", "conv2": "c2", "conv3": "c3", "proj": "p"}


def param_counts(cfg: ResNetConfig) -> Dict[str, int]:
    inner = bound = 0
    for g in gemm_workload(cfg, batch=1):
        if g.layer_class == "boundary":
            bound += g.k * g.n
        else:
            inner += g.k * g.n
    return {"inner": inner, "boundary": bound}


def layer_param_counts(cfg: ResNetConfig) -> Dict[str, int]:
    """{workload layer name: weight count}: the planner's footprint input."""
    return {g.name: g.k * g.n for g in gemm_workload(cfg, batch=1)}


def layer_classes(cfg: ResNetConfig) -> Dict[str, str]:
    return {g.name: g.layer_class for g in gemm_workload(cfg, batch=1)}


def inner_layer_names(cfg: ResNetConfig) -> List[str]:
    return [g.name for g in gemm_workload(cfg, batch=1)
            if g.layer_class != "boundary"]


def layer_weights(cfg: ResNetConfig, params) -> Dict[str, torch.Tensor]:
    """{workload layer name: float weight matrix (K, N)} of a QAT param
    tree: the planner's PTQ-sensitivity input."""
    out = {"stem": params["stem"]["w"], "fc": params["fc"]["w"]}
    for si, bi, cin, cmid, stride in _block_channels(cfg):
        key = f"s{si}b{bi}"
        for pkey, sfx in _PLAN_SUFFIX.items():
            if pkey in params[key]:
                out[key + sfx] = params[key][pkey]["w"]
    return out


def model_flops(cfg: ResNetConfig, *, batch: Optional[int] = None,
                tokens: Optional[int] = None, step: str = "train") -> float:
    b = batch if batch is not None else (tokens or 1)
    macs = sum(g.macs for g in gemm_workload(cfg, b))
    return (6.0 if step == "train" else 2.0) * macs


def total_params(cfg: ResNetConfig) -> int:
    c = param_counts(cfg)
    return c["inner"] + c["boundary"]


def active_params(cfg: ResNetConfig) -> int:
    return total_params(cfg)  # a dense CNN: every weight is active

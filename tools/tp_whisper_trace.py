#!/usr/bin/env python3
"""Where whisper-base's tensor-parallel training forward leaves the
one-device forward on an NVIDIA card: each encoder and decoder layer's
output, and each attention block's and MLP's, from two ranks of a (1, 2)
mesh sharing the card (gloo) against one device, at full width, on the
first batch of ``chip_smoke.py`` phase 24 (2 x 64 tokens, 1536 frames a
row, the seeded init).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 tools/tp_whisper_trace.py

Prints, record by record in forward order, how many values differ, the
largest difference and the relative L2 of the difference, with the
card's name and power limit.  No kernel is built.  Exits non-zero
without a card.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CELL = ("whisper-base", None, 2, 64)


def forward_records(api, params, batch, mesh):
    """The training forward over ``batch`` (no gradient) -> [(kind, output
    as a numpy array)] in forward order: 'attn' (a self attention block),
    'xattn' (a cross attention block), 'mlp', 'enc' / 'dec' (a layer)."""
    import torch
    from repro_torch.models import whisper as W
    from repro_torch.nn import attention as A
    rec = []
    saved = {"enc": (W, "_enc_layer_fwd"), "dec": (W, "_layer_fwd"),
             "attn": (A, "gqa_prefill"), "xattn": (W, "_cross_train"),
             "mlp": (W, "_mlp")}
    originals = {k: getattr(mod, name) for k, (mod, name) in saved.items()}

    def recorded(kind, fn):
        def call(*a, **kw):
            y = fn(*a, **kw)
            out = y if kind == "mlp" or kind == "enc" else y[0]
            rec.append((kind, out.float().cpu().numpy()))
            return y
        return call
    for kind, (mod, name) in saved.items():
        setattr(mod, name, recorded(kind, originals[kind]))
    try:
        with torch.no_grad():
            api.forward(params, batch["tokens"], mode="train",
                        frames=batch["frames"],
                        **({"mesh": mesh} if mesh is not None else {}))
    finally:
        for kind, (mod, name) in saved.items():
            setattr(mod, name, originals[kind])
    return rec


def rank(r, _args):
    import torch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.make_train_mesh((1, 2), devices=["cuda:0"] * 2)
    device = mesh_lib.local_device(mesh)
    api = cs.p24_api(CELL)
    sh = steps_lib.train_state_shardings(api, mesh)
    state = cs.p23_state(api, device, sh)
    batch = cs.p24_batches(api, CELL, device)[0]
    return forward_records(api, state["params"], batch, mesh)


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.launch import mesh as mesh_lib
    if not torch.cuda.is_available():
        print("tp_whisper_trace: torch sees no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    device = torch.device("cuda", 0)
    api = cs.p24_api(CELL)
    state = cs.p23_state(api, device)
    one = forward_records(api, state["params"],
                          cs.p24_batches(api, CELL, device)[0], None)
    del state
    torch.cuda.empty_cache()
    got = mesh_lib.spawn(rank, 2, ((),),
                         store_dir=str(ROOT / "build" / "whisper_trace"),
                         backend="gloo", timeout_s=300)[0]
    if len(got) != len(one):
        raise SystemExit(f"{len(one)} records on one device, {len(got)} on "
                         f"the mesh")
    for i, ((k1, a), (k2, b)) in enumerate(zip(one, got)):
        d = np.abs(a - b)
        cs.log(f"[whisper-trace] {i:2d} {k1:5s} {tuple(a.shape)}: "
               f"{int((d > 0).sum())} of {a.size} values differ, largest "
               f"{float(d.max()):.3e}, relative L2 "
               f"{float(np.linalg.norm(d) / np.linalg.norm(a)):.3e}  "
               f"({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

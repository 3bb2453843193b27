"""Export CLI — the counterpart of ``tools/export.py`` (the per-project
export.py successor; yolov5 export.py surface: one flag a backend).

    python -m deeplearning_tpu_torch.export --model vit_base_patch16_224 \\
        --num-classes 1000 --size 224 --attn flash_hb --format pt2 \\
        --out vit.pt2
    python -m deeplearning_tpu_torch.export --model mnist_cnn --channels 1 \\
        --size 28 --format onnx --out model.onnx --device cpu
    python -m deeplearning_tpu_torch.export --model yolox_s --size 640 \\
        --decode --format onnx --out yolox.onnx

``--format pt2`` writes a ``torch.export`` program (``.pt2``); a ViT on K1
or a Swin on K2 keeps each kernel launch as one custom-op node, and the
loaded program launches them. ``--format onnx`` builds the model in
float32 (a portable artifact), writes it through the port's own ONNX
writer and checks the load-back on a random probe (max |diff| <= 1e-3,
else exit 1). ``--format savedmodel`` raises ``ValueError``: the serving
artifact comes with ROADMAP Queue 1 item 8d.

Differences from ``tools/export.py``, by decision: ``--attn`` (the serve
CLI's names; default ``flash_hb``) picks a ViT's attention, so a ViT
exports on K1; ``--device`` (default ``cuda``; the tests pass ``cpu``);
``--format`` takes ``pt2`` where JAX takes ``stablehlo``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning_tpu_torch.export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--num-classes", type=int, default=10)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--format", choices=("pt2", "savedmodel", "onnx"),
                    default="pt2")
    ap.add_argument("--decode", action="store_true",
                    help="detectors: include the box decode in the graph "
                         "(pre-NMS raw detections, the yolov5 "
                         "export.py:29-159 export_detect / YOLOX "
                         "tools/export_onnx.py --decode analog)")
    ap.add_argument("--attn", default="flash_hb",
                    help="attention, as the serve CLI takes it: flash_hb "
                         "(default), flash, naive, sdpa")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", required=True)
    return ap


class _Decoded(torch.nn.Module):
    """A detector with its box decode (the grid tables as buffers)."""

    def __init__(self, model, decode, tables):
        super().__init__()
        self.model, self.decode = model, decode
        self.names = sorted(tables)
        for k in self.names:
            self.register_buffer(k, tables[k], persistent=False)

    def forward(self, x):
        return self.decode(self.model(x),
                           {k: getattr(self, k) for k in self.names})


def build(args) -> torch.nn.Module:
    """The model (or model + decode) to export, in eval mode on
    ``--device``."""
    from .. import hub
    kw = dict(hub.model_kwargs(args.model, args.attn, args.size))
    if args.format == "onnx":
        kw["dtype"] = torch.float32          # a portable float32 artifact
    if args.channels != 3:
        kw["in_chans"] = args.channels
    model, _ = hub.load(args.model, num_classes=args.num_classes,
                        seed=args.seed, ckpt=args.ckpt, device=args.device,
                        **kw)
    if not args.decode:
        return model
    hw = (args.size, args.size)
    dev = next(model.parameters()).device
    if args.model.startswith("yolox"):
        from ..models.detection.yolox import decode_outputs, yolox_grid
        centers, strides = yolox_grid(hw)
        tables = {"centers": torch.as_tensor(centers),
                  "strides": torch.as_tensor(strides)}
        decode = lambda raw, t: decode_outputs(  # noqa: E731
            raw, t["centers"], t["strides"])
    elif args.model.startswith("yolov5"):
        from ..models.detection.yolov5 import decode_yolov5, yolov5_grid
        tables = {k: torch.as_tensor(v) for k, v in yolov5_grid(hw).items()}
        decode = decode_yolov5
    else:
        raise SystemExit(f"--decode not supported for {args.model!r} "
                         "(yolox*/yolov5* only)")
    return _Decoded(model, decode,
                    {k: v.to(dev) for k, v in tables.items()}).eval()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .serialize import export_program, export_savedmodel, flops_estimate

    fn = build(args)
    dev = torch.device(args.device)
    example = torch.zeros((args.batch, args.size, args.size, args.channels),
                          device=dev)
    print(f"model FLOPs (fwd, batch {args.batch}): "
          f"{flops_estimate(fn, example) / 1e9:.2f} G")
    if args.format == "onnx":
        from .onnx import export_onnx, load_onnx, run_onnx
        blob = export_onnx(fn, [example], args.out)
        # load-back numeric self-check (yolov5 export.py:43 onnx.checker
        # + simplifier analog). A random probe, not zeros: conv(0) = 0
        # would mask a mis-serialized stem.
        probe = np.random.default_rng(0).normal(
            size=example.shape).astype(np.float32)
        got = run_onnx(load_onnx(blob), probe)[0]
        with torch.no_grad():
            want = fn(torch.from_numpy(probe).to(dev)).float().cpu().numpy()
        err = float(np.abs(got - want).max())
        print(f"wrote {len(blob)} bytes of ONNX to {args.out}; "
              f"load-back max|diff|={err:.2e}")
        if not err <= 1e-3:
            print("ONNX self-check FAILED")
            return 1
    elif args.format == "pt2":
        blob = export_program(fn, [example], args.out)
        print(f"wrote {len(blob)} bytes of .pt2 to {args.out}")
    else:
        export_savedmodel(fn, [example], args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

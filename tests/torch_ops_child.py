"""Runs ops of the C++ op library (``native/dltpu_ops.cpp``) in a process
that imports torch only.

The library defines ``dltpu::flash_fwd``, ``window_attn`` and
``nms_sweep`` from C++, and the port's Python ops define the same names,
so the two never share a process: a test saves the calls it wants to
``<in.pt>``, runs this file, and holds what it leaves in ``<out.pt>``
against the Python ops in its own process.

    python tests/torch_ops_child.py <libdltpu_ops.so> <in.pt> <out.pt>

``in.pt``: {"device": "cpu" | "cuda", "calls": [(op name, args), ...]}
with tensor args on the CPU (moved to the device here). ``out.pt``: the
ops' schemas as strings, each call's results (CPU tensors with their
strides on the device) or its error text, and the library's counters
(``dltpu_launches``, ``dltpu_plain_runs``) after the calls.
"""

import ctypes
import sys

import torch

OPS = ("flash_fwd", "window_attn", "nms_sweep")


def main(lib_path, in_path, out_path):
    torch.set_num_threads(1)
    torch.ops.load_library(lib_path)
    counters = ctypes.CDLL(lib_path)
    for fn in (counters.dltpu_launches, counters.dltpu_plain_runs):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_long
    payload = torch.load(in_path, weights_only=False)
    dev = torch.device(payload["device"])
    out = {"schemas": {n: str(getattr(torch.ops.dltpu, n).default._schema)
                       for n in OPS},
           "results": []}
    for name, args in payload["calls"]:
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a
                for a in args]
        try:
            res = getattr(torch.ops.dltpu, name)(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        except Exception as exc:            # the test reads the text
            out["results"].append(f"{type(exc).__name__}: {exc}")
            continue
        res = res if isinstance(res, tuple) else (res,)
        out["results"].append([(t.cpu(), tuple(t.stride())) for t in res])
    out["launches"] = {n: counters.dltpu_launches(n.encode()) for n in OPS}
    out["plain_runs"] = {n: counters.dltpu_plain_runs(n.encode())
                         for n in OPS}
    torch.save(out, out_path)


if __name__ == "__main__":
    main(*sys.argv[1:4])

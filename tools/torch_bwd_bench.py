#!/usr/bin/env python3
"""Times K1's backward kernels on the card, for the checkout's source or for
variants of it.

    python3 tools/torch_bwd_bench.py [SOURCE.cu ...]
    python3 tools/torch_bwd_bench.py --f32 [--root DIR] [--label NAME]

Builds each source (default: ``kernels/csrc/flash_attention_bwd.cu``) with
the port's nvcc flags into a library of its own, all nvcc in parallel,
prints the registers and spills of its bf16 kernels (``-Xptxas -v``) and
any ptxas performance note (C75xx: wgmma serialised), then for each shape
and source one line in bf16: each gradient's excess beyond one bf16
rounding of the f32 plain version over max|ref| (``chip_smoke.py`` 18a's
measure; OK within 1e-4) and each stage's device ms (``chip_smoke.py``'s
``cuda_ms`` with the queue held), launched through the source's own
``os_flash_attention_bwd``. A variant is a copy of the source with one
change (launch bounds, tile order), so that the sources compare within one
call on one card.

``--f32`` times the float32 backward instead, through the package of the
checkout at DIR (default: this one; its kernels built from its sources):
at 18a's three shapes, ``flash_attention_backward`` per call and in device
time, its largest error against the plain version beside 18a's gate
(1e-4 x max(max|ref|, 1)), the plain version's time, SDPA's float32
backward (autograd of one forward, replayed; its backend named) and both
bounds of the 5 products (CUDA cores at 67 TFLOP/s, split operands at
495 / 3 TFLOP/s). Run it once for each checkout in one call (parent,
change, change, parent). Needs CUDA.
"""

from __future__ import annotations

import ctypes
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# (B, H, Tq, Tk, D, causal): 18a's three shapes, D 32 at 1500, a ragged
# causal rectangle each way
SHAPES = [
    (1, 20, 1500, 1500, 64, False),
    (2, 20, 64, 1500, 64, False),
    (2, 20, 64, 64, 64, True),
    (1, 4, 1500, 1500, 32, False),
    (1, 2, 100, 1500, 64, True),
    (2, 3, 100, 37, 64, True),
]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(sources: list[Path], out_dir: Path, c) -> dict:
    """{name: the library's os_flash_attention_bwd} of the sources that built."""
    from open_speech_tpu_torch.kernels import build as B

    procs = {}
    for src in sources:
        lib = out_dir / f"{src.stem}.so"
        procs[src.stem] = (subprocess.Popen([B.nvcc_path(), *B.NVCC_FLAGS, "-o", str(lib), str(src)],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    entries = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        for k in c.ptxas_kernels(log):
            if "_bf16" in k["name"]:
                print(f"{name}: registers {k['registers']} spills {k['spill_bytes']} B  {k['name']}", flush=True)
        for line in log.splitlines():
            if "(C75" in line:
                print(f"{name}: {line.strip()}", flush=True)
        if proc.returncode:
            print(f"{name}: nvcc exit {proc.returncode}\n{log}", flush=True)
            continue
        fn = ctypes.CDLL(str(lib)).os_flash_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        entries[name] = fn
    return entries


def f32_lines(c, root: str, label: str) -> None:
    """The float32 backward of the checkout at ``root`` at 18a's shapes."""
    import json

    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(Path(root).resolve()))
    for mod in [m for m in sys.modules if m.startswith("open_speech_tpu_torch")]:
        del sys.modules[mod]
    from open_speech_tpu_torch.kernels import build as B
    from open_speech_tpu_torch.ops import attention as A

    sys.path.insert(0, str(REPO / "tools"))
    from torch_flash_bench import sdpa_backend

    print(f"{label}: {A.__file__}", flush=True)
    for k in c.ptxas_kernels(B.build(force=True).get("flash_attention_bwd", "")):
        if "f32" in k["name"]:
            print(f"{label}: registers {k['registers']} spills {k['spill_bytes']} B  {k['name']}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for b, h, t_q, t_k, d, causal in c.BWD_SHAPES:
        q = torch.randn(b, h, t_q, d, generator=gen, device="cuda")
        k, v = (torch.randn(b, h, t_k, d, generator=gen, device="cuda") for _ in range(2))
        d_out = torch.randn(b, h, t_q, d, generator=gen, device="cuda")
        call = lambda: A.flash_attention_backward(q, k, v, d_out, causal=causal)  # noqa: E731
        got = call()
        want = A.flash_attention_backward_reference(q, k, v, d_out, causal=causal)
        err = max(((g - w).abs().max() / max(w.abs().max().item(), 1.0)).item() for g, w in zip(got, want))
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
        sdpa_bwd = lambda: torch.autograd.grad(o_sdpa, (qs, ks, vs), d_out, retain_graph=True)  # noqa: E731
        res = {"label": label, "shape": [b, h, t_q, t_k, d, int(causal)],
               "err_over_gate_scale": err, "ok": err <= c.BWD_TOL["float32"],
               "ms": c.cuda_ms(call), "device_ms": c.cuda_ms(call, held=True),
               "plain_ms": c.cuda_ms(lambda: A.flash_attention_backward_reference(q, k, v, d_out, causal=causal),
                                     iters=3, warmup=1),
               "sdpa_backend": sdpa_backend(q, k, v, is_causal=causal),
               "sdpa_bwd_ms": c.cuda_ms(sdpa_bwd), "sdpa_bwd_device_ms": c.cuda_ms(sdpa_bwd, held=True)}
        for route in ("cuda_core", "split"):
            res[f"bound_{route}_ms"], res[f"bound_{route}_by"] = c._bwd_bound_ms(
                b, h, t_q, t_k, d, causal, 4, 5, 3, 4, 0, split=route == "split")
        print(json.dumps(res), flush=True)
        del qs, ks, vs, o_sdpa, got, want


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sources", nargs="*", help="bf16 variants of flash_attention_bwd.cu")
    ap.add_argument("--f32", action="store_true", help="time the float32 backward of a checkout")
    ap.add_argument("--root", default=str(REPO), help="--f32: the checkout whose package is timed")
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_bench: no CUDA device", file=sys.stderr)
        return 1
    c = _chip_smoke()
    c.phase_device()
    if args.f32:
        f32_lines(c, args.root, args.label)
        return 0

    from open_speech_tpu_torch.ops import attention as A

    sources = [Path(s) for s in args.sources] or [REPO / "open_speech_tpu_torch/kernels/csrc/flash_attention_bwd.cu"]
    with tempfile.TemporaryDirectory() as tmp:
        entries = build(sources, Path(tmp), c)
        gen = torch.Generator(device="cuda").manual_seed(3)
        stream = torch.cuda.current_stream().cuda_stream
        for b, h, t_q, t_k, d, causal in SHAPES:
            q = torch.randn(b, h, t_q, d, generator=gen, device="cuda").bfloat16()
            k, v = (torch.randn(b, h, t_k, d, generator=gen, device="cuda").bfloat16() for _ in range(2))
            d_out = torch.randn(b, h, t_q, d, generator=gen, device="cuda").bfloat16()
            want = A.flash_attention_backward_reference(*(t.float() for t in (q, k, v, d_out)), causal=causal)
            for name, fn in entries.items():
                grads = tuple(torch.empty_like(t) for t in (q, k, v))
                stats = torch.empty(2, b, h, t_q, dtype=torch.float32, device="cuda")

                def launch(stage: int) -> None:
                    err = fn(*(t.data_ptr() for t in (q, k, v, d_out, *grads)), stats[0].data_ptr(),
                             stats[1].data_ptr(), stage, b, h, t_q, t_k, d, 1, d**-0.5, int(causal), stream)
                    if err:
                        raise RuntimeError(f"{name}: stage {stage}: cudaError {err}")

                for stage in range(3):
                    launch(stage)
                torch.cuda.synchronize()
                excess = [c._beyond_bf16_rounding(g, w) for g, w in zip(grads, want)]
                ms = [c.cuda_ms(lambda s=stage: launch(s), held=True) for stage in range(3)]
                print(f"{name} [{b},{h},{t_q},{t_k},{d}] causal={int(causal)}: beyond bf16 rounding dq "
                      f"{excess[0]:.2e} dk {excess[1]:.2e} dv {excess[2]:.2e} "
                      f"{'OK' if max(excess) <= c.BWD_TOL['bfloat16'] else 'OVER'}; device ms prep {ms[0]:.4f} "
                      f"dkdv {ms[1]:.4f} dq {ms[2]:.4f} sum {sum(ms):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

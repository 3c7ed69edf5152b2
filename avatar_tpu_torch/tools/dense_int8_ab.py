"""A/B timings of the Hopper dense-bias attention (G) and int8 product (H) on one card.

    python3 -m avatar_tpu_torch.tools.dense_int8_ab

Builds, beside the committed kernels, variants of their sources written
into ``csrc/build/variants/`` (git-ignored; ``forward_ab.build_variant``)
and times each against the committed kernel in turns (committed, variant,
variant, committed), by the profiler's device time of the kernel alone.

H (``csrc/int8_matmul_sm90.cu``) at 5376 x 2048 x 2048, 5376 x 2048 x
8192, 5376 x 8192 x 2048 (the DiT's W8A8 shapes at 161 frames, 512 px),
832 x 2048 x 2048 and 5000 x 2048 x 2048, bf16 out with a bias:

- ``tile128`` / ``tile256``: the committed kernel with 128- or 256-column
  output tiles (the wrapper picks one by ``matmul_tile_n``);
- ``register_store``: bf16 rows stored from the registers in pairs instead
  of through the staging tiles and TMA stores (the outputs must be the same
  bits);
- ``no_epilogue``: the epilogue skipped, nothing stored: what the main loop
  and the pipeline take alone.

G (``csrc/flash_dense_sm90.cu``, head dim 64) at ``chip_smoke.py``'s two
dense cases, T5-XXL's [2, 64, 256, 64] with a per-head bias and the DiT's
[1, 32, 5376, 64] with one shared bias:

- ``fwd_keys64``: the forward walks 64 keys per stage through 3 stages
  instead of 128 through 2;
- ``bwd_stages2``: the three backward kernels with 2 ring stages instead
  of 3.

Prints the card's name and power limit, then one JSON line of
milliseconds. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from avatar_tpu_torch.ops import flash_attention as fa
from avatar_tpu_torch.ops import int8_matmul as i8
from avatar_tpu_torch.ops import kernel_build
from avatar_tpu_torch.tools.forward_ab import build_variant, in_turns

REGISTER_STORE = (("  if (N % 8 == 0)\n    return launch<kBN, __nv_bfloat16, true>",
                   "  if (N < 0)\n    return launch<kBN, __nv_bfloat16, true>"),)
NO_EPILOGUE = (("    // ---- epilogue ----\n",
                "    // ---- epilogue ----\n    if (M > 0) continue;\n"),)
FWD_KEYS64 = (("constexpr int kFwdN = kD == 64 ? 128 : 64;", "constexpr int kFwdN = 64;"),
              ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;"))
BWD_STAGES2 = (("constexpr int kBwdStages = kD == 64 ? 3 : 2;",
                "constexpr int kBwdStages = 2;"),)
I8_SHAPES = ((5376, 2048, 2048), (5376, 2048, 8192), (5376, 8192, 2048), (832, 2048, 2048),
             (5000, 2048, 2048))


def int8_caller(lib: ctypes.CDLL, tile_n=None):
    """``w8a8_matmul_sm90`` of ``lib`` at ``tile_n`` columns per tile (the
    wrapper's choice when None), bf16 out."""
    fn = lib.w8a8_matmul_sm90
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x_q, x_s, w_q, w_s, bias, out):
        m, k = x_q.shape
        n = w_q.shape[0]
        err = fn(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), m, n, k, 0,
                 tile_n or i8.matmul_tile_n(m, n), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"w8a8_matmul_sm90 failed with {err}")
    return call


def dense_caller(lib: ctypes.CDLL, kernel: str):
    """``flash_dense_<kernel>_sm90_bf16`` of ``lib`` (kernel "fwd",
    "bwd_dkv", "bwd_dq" or "bwd_db") on contiguous tensors."""
    fn = getattr(lib, f"flash_dense_{kernel}_sm90_bf16")
    n_ptrs = {"fwd": 6, "bwd_dkv": 9}.get(kernel, 8)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(ptrs, b, h, lq, lk, group, scale):
        err = fn(*ptrs, b, h, lq, lk, group, 64, scale,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_dense_{kernel}_sm90_bf16 failed with {err}")
    return call


def int8_times(g) -> dict:
    csrc = kernel_build.CSRC / "int8_matmul_sm90.cu"
    committed = kernel_build.load("int8_matmul_sm90")
    libs = {"register_store": build_variant("i8_register_store", csrc, REGISTER_STORE),
            "no_epilogue": build_variant("i8_no_epilogue", csrc, NO_EPILOGUE)}
    result = {}
    for m, k, n in I8_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        x_s = torch.rand(m, 1, generator=g, device="cuda") * 1e-2 + 1e-3
        w_s = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-4
        bias = torch.randn(n, generator=g, device="cuda")
        calls = {"committed": int8_caller(committed),
                 "tile128": int8_caller(committed, 128), "tile256": int8_caller(committed, 256),
                 **{name: int8_caller(lib) for name, lib in libs.items()}}
        outs = {name: torch.empty(m, n, device="cuda", dtype=torch.bfloat16) for name in calls}
        for name, fn in calls.items():
            fn(x_q, x_s, w_q, w_s, bias, outs[name])
        torch.cuda.synchronize()
        for name in calls:
            if name != "no_epilogue" and not torch.equal(outs[name], outs["committed"]):
                raise RuntimeError(f"H {m}x{k}x{n}: {name} differs from the committed kernel")
        result[f"H {m}x{k}x{n}"] = in_turns(
            {name: (lambda fn=fn, o=outs[name]: fn(x_q, x_s, w_q, w_s, bias, o))
             for name, fn in calls.items()}, "w8a8_sm90_kernel")
    return result


def dense_times(g) -> dict:
    from chip_smoke import dense_cases

    csrc = kernel_build.CSRC / "flash_dense_sm90.cu"
    committed = kernel_build.load("flash_dense_sm90")
    keys64 = build_variant("dense_fwd_keys64", csrc, FWD_KEYS64)
    stages2 = build_variant("dense_bwd_stages2", csrc, BWD_STAGES2)
    result = {}
    for label, (q, k, v, bias, gout, scale, _) in dense_cases(g).items():
        bias3 = fa._dense_bias3(bias)
        b, h, lq, _ = q.shape
        lk = k.shape[2]
        dims = (b, h, lq, lk, b * h // bias3.shape[0], float(scale))
        out, lse = torch.empty_like(q), torch.empty(b, h, lq, device="cuda")
        fwd_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias3.data_ptr(),
                    out.data_ptr(), lse.data_ptr())
        dense_caller(committed, "fwd")(fwd_ptrs, *dims)
        delta = (gout.float() * out.float()).sum(-1)
        grads = {"bwd_dkv": (torch.empty_like(k), torch.empty_like(v)),
                 "bwd_dq": (torch.empty_like(q),), "bwd_db": (torch.empty_like(bias3),)}
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), bias3.data_ptr())
        times = {"fwd": in_turns({
            name: (lambda fn=dense_caller(lib, "fwd"): fn(fwd_ptrs, *dims))
            for name, lib in (("committed", committed), ("fwd_keys64", keys64))},
            "flash_dense_fwd_sm90_kernel")}
        for kernel, outs in grads.items():
            ptrs = head + tuple(t.data_ptr() for t in outs)
            times[kernel] = in_turns({
                name: (lambda fn=dense_caller(lib, kernel), p=ptrs: fn(p, *dims))
                for name, lib in (("committed", committed), ("bwd_stages2", stages2))},
                f"flash_dense_{kernel}_sm90_kernel")
        result[f"G {label}"] = times
        torch.cuda.empty_cache()
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("dense_int8_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    kernel_build.build_all(["int8_matmul_sm90", "flash_dense_sm90"])
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {**int8_times(g), **dense_times(g)}
    print(smi, flush=True)
    print(json.dumps({"card": smi, "ms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

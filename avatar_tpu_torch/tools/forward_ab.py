"""A/B timings of the Hopper attention forward kernels (A, C, D, E) on one card.

    python3 -m avatar_tpu_torch.tools.forward_ab [--parent DIR]

Builds, beside the committed kernels, variants of their sources written
into ``csrc/build/variants/`` (git-ignored) and times each against the
committed kernel in turns (committed, variant, variant, committed), by the
profiler's device time of the kernel alone:

- ``per_item``: one CTA per work item instead of one persistent CTA per SM
  (``persistent_ctas`` returns the item count); the outputs must be the
  same bits;
- ``copy`` (A only): the rotation replaced by a copy of the staged halves:
  every load, staging step and barrier of A stays, the rotation's
  arithmetic and its cos / sin reads go;
- ``c_prerotated`` (A only): the bounded kernel C on q, k and v rotated
  beforehand and laid out head-major, contiguous: A's work without the
  rotation;
- ``online`` (E only): the committed kernel's online mode (D) on E's
  inputs: E's work without its max pass;
- ``parent`` (C and D, with ``--parent DIR``, an unpacked earlier checkout):
  that checkout's ``csrc/flash_forward_sm90.cu``.

Shapes: A at 1 x 832, 8 x 480 and 1 x 5376 tokens (32 heads of 64); E at
[1, 32, 637, 64], the training self-attention [8, 32, 480, 64] and
cross-attention (480 x 256, 200 keys kept, the last sample fully masked);
C and D at [1, 32, 5376, 64]. Prints the card's name and power limit, then
one JSON line of milliseconds. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from avatar_tpu_torch.ops import flash_attention as fa
from avatar_tpu_torch.ops import kernel_build
from avatar_tpu_torch.ops.rope import apply_rotary_emb_split

VARIANT_DIR = kernel_build.BUILD_DIR / "variants"
PER_ITEM = ("return n_items < sms ? n_items : sms;", "return n_items;")
COPY = (
    ("r1[j] = pack_bf16(a.x * co.x - bb.x * si.x, a.y * co.y - bb.y * si.y);",
     "r1[j] = pack_bf16(a.x, a.y);"),
    ("r2[j] = pack_bf16(bb.x * co.x + a.x * si.x, bb.y * co.y + a.y * si.y);",
     "r2[j] = pack_bf16(bb.x, bb.y);"),
    ("const uint4 cv = *reinterpret_cast<const uint4*>(raw + 2 * kBufBytes + off);",
     "const uint4 cv = x1v;"),
    ("const uint4 sv = *reinterpret_cast<const uint4*>(raw + 3 * kBufBytes + off);",
     "const uint4 sv = x2v;"),
)
HEADS, HEAD_DIM = 32, 64


def _patched(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build_variant(name: str, source: Path, subs=(), header_subs=()) -> ctypes.CDLL:
    """Compile ``source`` with ``subs`` applied (and the shared forward
    header with ``header_subs``, beside it) into its own library."""
    out = VARIANT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    (out / source.name).write_text(_patched(source.read_text(), subs))
    if header_subs:
        header = source.parent / "attention_fwd_sm90.cuh"
        (out / header.name).write_text(_patched(header.read_text(), header_subs))
    lib = out / f"{name}.so"
    cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-I", str(source.parent),
           "-o", str(lib), str(out / source.name)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    return ctypes.CDLL(str(lib))


def rope_caller(lib: ctypes.CDLL):
    fn = lib.rope_attention_sm90_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, cos, sin, out):
        b, length, c = q.shape
        d = c // HEADS
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 out.data_ptr(), b, length, HEADS, d, d**-0.5, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rope_attention_sm90_bf16 failed with {err}")
    return call


def flash_caller(lib: ctypes.CDLL, mode_arg):
    """``flash_sm90_bf16`` of ``lib``; ``mode_arg`` maps "bounded", "online"
    or "single" to that source's last integer argument."""
    fn = lib.flash_sm90_bf16
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, mask, out, lse, mode):
        b, h, lq, d = q.shape
        strides = [x for t in (q, k, v, out) for x in fa._tma_strides(t)]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 b, h, lq, k.shape[2], d, *strides, 1.0, mode_arg(mode),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_sm90_bf16 failed with {err}")
    return call


def device_ms(fn, match: str, reps: int = 20) -> float:
    """Mean device time per call of the kernels ``fn`` launches whose name
    holds ``match`` (torch.profiler). Raises where three profiling sessions
    record none of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a profiling session now and then records no kernel at all: it is
    # taken again, up to three times
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and match in e.key)
        if total > 0:
            return total / reps / 1e3
    raise RuntimeError(f"the profiler saw no device time for {match}")


def in_turns(calls: dict, match: str) -> dict:
    """{name: [ms, ms]}: the committed call first and last, each variant
    twice in the middle."""
    names = [n for n in calls if n != "committed"]
    order = ["committed"] + names + names[::-1] + ["committed"]
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(device_ms(calls[name], match))
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier checkout whose flash_forward_sm90.cu "
                             "C and D are timed too")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("forward_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    csrc = kernel_build.CSRC
    modes = {"bounded": 0, "online": 1, "single": 2}
    rope = {"committed": rope_caller(kernel_build.load("rope_attention_sm90")),
            "per_item": rope_caller(build_variant(
                "rope_per_item", csrc / "rope_attention_sm90.cu", header_subs=(PER_ITEM,))),
            "copy": rope_caller(build_variant("rope_copy", csrc / "rope_attention_sm90.cu",
                                              COPY))}
    flash = {"committed": flash_caller(kernel_build.load("flash_forward_sm90"), modes.get),
             "per_item": flash_caller(build_variant(
                 "flash_per_item", csrc / "flash_forward_sm90.cu", header_subs=(PER_ITEM,)),
                 modes.get)}
    if args.parent is not None:
        # before the whole-row mode the last argument was `bounded`
        flash["parent"] = flash_caller(build_variant(
            "flash_parent", args.parent / "avatar_tpu_torch/csrc/flash_forward_sm90.cu"),
            lambda mode: int(mode == "bounded"))

    g = torch.Generator(device="cuda").manual_seed(0)

    def rows(*shape):
        x = torch.randn(shape, generator=g, device="cuda")
        return (x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()).bfloat16()

    result = {}
    for b, length in ((1, 832), (8, 480), (1, 5376)):
        c = HEADS * HEAD_DIM
        q, k = rows(b, length, c), rows(b, length, c)
        v = torch.randn(b, length, c, generator=g, device="cuda").bfloat16()
        ang = torch.rand(b, length, c // 2, generator=g, device="cuda") * 6.3
        cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
        outs = {n: torch.empty_like(q) for n in rope}
        for name, fn in rope.items():
            fn(q, k, v, cos, sin, outs[name])
        torch.cuda.synchronize()
        if not torch.equal(outs["committed"], outs["per_item"]):
            raise RuntimeError(f"A {b}x{length}: per_item differs from the committed kernel")

        def head_major(t):
            return fa.split_to_head_major(t, HEADS).reshape(
                b, length, HEADS, HEAD_DIM).transpose(1, 2).contiguous()

        qh = head_major(apply_rotary_emb_split(q, (cos, sin)))
        kh = head_major(apply_rotary_emb_split(k, (cos, sin)))
        vh = v.reshape(b, length, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
        oh, lse = torch.empty_like(qh), torch.empty(b, HEADS, length, device="cuda")
        calls = {name: (lambda fn=fn, o=outs[name]: fn(q, k, v, cos, sin, o))
                 for name, fn in rope.items()}
        times = in_turns(calls, "rope_sm90_kernel")
        times["c_prerotated"] = [device_ms(lambda: flash["committed"](
            qh, kh, vh, None, oh, lse, "bounded"), "flash_sm90_kernel") for _ in range(2)]
        result[f"A {b}x{length}"] = times
    cases = {"E 1x637": (1, 637, 637, False, "single"),
             "E self 8x480": (8, 480, 480, False, "single"),
             "E cross 8x480x256": (8, 480, 256, True, "single"),
             "C 1x5376": (1, 5376, 5376, False, "bounded"),
             "D 1x5376": (1, 5376, 5376, False, "online")}
    for label, (b, lq, lk, masked, mode) in cases.items():
        q, k = rows(b, HEADS, lq, HEAD_DIM), rows(b, HEADS, lk, HEAD_DIM)
        v = torch.randn(b, HEADS, lk, HEAD_DIM, generator=g, device="cuda").bfloat16()
        mask = None
        if masked:
            mask = torch.ones(b, lk, device="cuda")
            mask[:, 200:] = 0.0
            mask[-1] = 0.0
        variants = {n: fn for n, fn in flash.items() if mode != "single" or n != "parent"}
        outs = {n: (torch.empty_like(q), torch.empty(b, HEADS, lq, device="cuda"))
                for n in variants}
        for name, fn in variants.items():
            fn(q, k, v, mask, *outs[name], mode)
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(outs["committed"], outs["per_item"])):
            raise RuntimeError(f"{label}: per_item differs from the committed kernel")
        calls = {name: (lambda fn=fn, o=outs[name]: fn(q, k, v, mask, *o, mode))
                 for name, fn in variants.items()}
        if mode == "single":
            calls["online"] = lambda o=outs["committed"]: flash["committed"](
                q, k, v, mask, *o, "online")
        result[label] = in_turns(calls, "flash_sm90_kernel")
    print(smi, flush=True)
    print(json.dumps({"card": smi, "ms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A/B timings of the Hopper kernels against variants of their own sources, on one card.

    python3 -m avatar_tpu_torch.tools.kernel_ab [FAMILY ...]

FAMILY is one of rope (A), flash (C, D, E), dense (G), int8 (H), token (B),
act (K), rmsq (J) and levels (L1); every family by default. Run it from the repo root (the
shapes of ``chip_smoke.py`` are imported from it).

A variant is a data entry of ``VARIANTS``: the source it patches, the
(old, new) pairs applied to that source and to the shared forward header
``attention_fwd_sm90.cuh``, and the rule its output is held to against the
committed kernel's on the same inputs ("exact": the same bits, "none": not
compared, where the variant computes something else). Every variant is
built into its own library under ``csrc/build/variants/`` (git-ignored),
all with one ``nvcc`` each, started together. Each case then runs every
call once, checks the rules, and times the calls in turns (committed,
the others, the others reversed, committed) by the profiler's device time
of the kernel alone.

Variants and the further calls of each family:

- rope, A at 1 x 832, 8 x 480 and 1 x 5376 tokens: ``per_item`` (one CTA
  per work item, not one persistent CTA per SM), ``copy`` (the rotation
  replaced by a copy of the staged halves: every load, staging step and
  barrier stays); ``c_prerotated``: the committed C on q, k rotated
  beforehand, head-major, contiguous (A's work without the rotation);
- flash, E at [1, 32, 637, 64], the training self-attention [8, 32, 480,
  64] and cross-attention (480 x 256, 200 keys kept, the last sample
  fully masked), C and D at [1, 32, 5376, 64]: ``per_item``; ``online``
  (E only): the committed D on E's inputs (E without its max pass);
- dense, G's four kernels at ``chip_smoke.dense_cases``: ``fwd_keys64``
  (the forward over 64 keys per stage through 3 stages, not 128 through
  2), ``bwd_stages2`` (the backward's rings of 2 stages, not 3);
- int8, H at the DiT's W8A8 shapes, 832 x 2048 x 2048 and 5000 x 2048 x
  2048: ``register_store`` (bf16 rows stored from the registers, not
  through the staging tiles and TMA stores), ``no_epilogue`` (nothing
  stored: the main loop and pipeline alone); ``tile128`` / ``tile256``:
  the committed kernel at 128 or 256 columns per tile;
- token, B at ``chip_smoke.TOKEN_SHAPES`` bounded (as the DiT runs it)
  and at 832 x 256 and the training shape unbounded: ``stages3`` (a ring
  of 3 stages, not 4);
- act, K's register kernel at [1, 5376, 8192] for each activation:
  ``rows128`` (128 threads a row of twice the chunks, not 256),
  ``clip_level`` (each level as rintf, the clip and a conversion, as the
  row-block kernel computes it, not one rounding conversion);
- rmsq, J's register kernel at [1, 5376, 2048] with and without shift:
  ``block_row`` (256 threads a row, K's layout, not a warp a row; the sum
  of squares is added in another order, so not compared), ``cvec_global``
  (cvec and shift read from global memory for every row, not staged in
  shared memory once per CTA); and on I's input, [5376, 2048], the
  committed I against ``i_on_j`` (J's kernel with the norm and modulation
  compiled out, y = x: I's function), whose levels and scales must equal
  I's;
- levels, kernel L1 (``int8_conv3d_sm90.cu``) at the 2B VAE's three
  largest conv inputs, [1, 128 | 48, 97, 64, 64] and [1, 256, 49, 32, 32]
  in bf16: ``ldcs`` (the loads as ``__ldcs``, evict-first), ``tile256``
  / ``tile64`` (256 or 64 positions a block, not 128); ``first_design``:
  the first L1 of ``int8_conv3d.cu`` on the same input; ``copy``: a
  device copy that reads and writes as many bytes as L1 (not compared).

Prints the card's name and power limit, then one JSON line of
milliseconds. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from avatar_tpu_torch.ops import flash_attention as fa
from avatar_tpu_torch.ops import int8_matmul as i8
from avatar_tpu_torch.ops import kernel_build

VARIANT_DIR = kernel_build.BUILD_DIR / "variants"
HEADER = "attention_fwd_sm90.cuh"
HEADS, HEAD_DIM = 32, 64
I8_SHAPES = ((5376, 2048, 2048), (5376, 2048, 8192), (5376, 8192, 2048), (832, 2048, 2048),
             (5000, 2048, 2048))

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


class Variant(NamedTuple):
    source: str                        # in csrc/
    subs: Tuple = ()                   # (old, new) pairs applied to the source
    header_subs: Tuple = ()            # and to the shared forward header
    rule: str = "exact"                # "exact" or "none"


VARIANTS: Dict[str, Dict[str, Variant]] = {
    "rope": {"per_item": Variant("rope_attention_sm90.cu", header_subs=(PER_ITEM,)),
             "copy": Variant("rope_attention_sm90.cu", COPY, rule="none")},
    "flash": {"per_item": Variant("flash_forward_sm90.cu", header_subs=(PER_ITEM,))},
    "dense": {
        "fwd_keys64": Variant("flash_dense_sm90.cu", (
            ("constexpr int kFwdN = kD == 64 ? 128 : 64;", "constexpr int kFwdN = 64;"),
            ("constexpr int kFwdStages = 2;", "constexpr int kFwdStages = 3;")), rule="none"),
        "bwd_stages2": Variant("flash_dense_sm90.cu", (
            ("constexpr int kBwdStages = kD == 64 ? 3 : 2;", "constexpr int kBwdStages = 2;"),),
            rule="none")},
    "int8": {
        "register_store": Variant("int8_matmul_sm90.cu", (
            ("  if (N % 8 == 0)\n    return launch<kBN, __nv_bfloat16, true>",
             "  if (N < 0)\n    return launch<kBN, __nv_bfloat16, true>"),)),
        "no_epilogue": Variant("int8_matmul_sm90.cu", (
            ("    // ---- epilogue ----\n",
             "    // ---- epilogue ----\n    if (M > 0) continue;\n"),), rule="none")},
    "token": {"stages3": Variant("token_attention_sm90.cu", (
        ("constexpr int kStages = kD == 64 ? 4 : 2;",
         "constexpr int kStages = kD == 64 ? 3 : 2;"),))},
    "act": {
        "rows128": Variant("row_quant.cu", (
            ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),)),
        "clip_level": Variant("row_quant.cu", (
            ("      const int level = __float2int_rn(__fmul_rn(y[c][e], inv));",
             "      const int level = __float2int_rn(\n"
             "          fminf(fmaxf(rintf(__fmul_rn(y[c][e], inv)), -127.0f), 127.0f));"),))},
    "rmsq": {
        "block_row": Variant("row_quant.cu", (
            ("  int group = 1;  // warps a row", "  int group = kWarps;  // warps a row"),),
            rule="none"),
        "cvec_global": Variant("row_quant.cu", (
            ("constexpr bool kStageModulation = true;",
             "constexpr bool kStageModulation = false;"),)),
        "i_on_j": Variant("row_quant.cu", (
            ("constexpr bool kNormModulate = true;", "constexpr bool kNormModulate = false;"),))},
    "levels": {
        "ldcs": Variant("int8_conv3d_sm90.cu", (
            ("      raw[i] = *reinterpret_cast<const uint4*>(x + (b * C + c) * P + p);",
             "      raw[i] = __ldcs(reinterpret_cast<const uint4*>(x + (b * C + c) * P + p));"),)),
        "tile256": Variant("int8_conv3d_sm90.cu", (
            ("launch_quant_tile<InT, true, 128>", "launch_quant_tile<InT, true, 256>"),)),
        "tile64": Variant("int8_conv3d_sm90.cu", (("  if (wide)\n", "  if (false)\n"),))},
}
# each family's committed library
COMMITTED = {"rope": "rope_attention_sm90", "flash": "flash_forward_sm90",
             "dense": "flash_dense_sm90", "int8": "int8_matmul_sm90",
             "token": "token_attention_sm90", "act": "row_quant", "rmsq": "row_quant",
             "levels": "int8_conv3d_sm90"}


def _patched(text: str, subs) -> str:
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant: {old!r} not in the source")
        text = text.replace(old, new)
    return text


def build_variant(name: str, v: Variant) -> ctypes.CDLL:
    """Compile ``v`` into its own library ``csrc/build/variants/<name>/``."""
    source = kernel_build.CSRC / v.source
    out = VARIANT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    (out / source.name).write_text(_patched(source.read_text(), v.subs))
    if v.header_subs:
        (out / HEADER).write_text(_patched((source.parent / HEADER).read_text(),
                                           v.header_subs))
    lib = out / f"{name}.so"
    cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-I", str(source.parent),
           "-o", str(lib), str(out / source.name)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name}:\n{proc.stdout}")
    return ctypes.CDLL(str(lib))


def build_libs(families) -> Dict[str, Dict[str, ctypes.CDLL]]:
    """{family: {"committed" or variant name: library}}, every build started
    together."""
    # rope's c_prerotated runs the committed C, levels' first_design the
    # first L1
    extra = (["flash_forward_sm90"] if "rope" in families else []) + (
        ["int8_conv3d"] if "levels" in families else [])
    committed = kernel_build.build_all([COMMITTED[f] for f in families] + extra)
    jobs = {(f, n): v for f in families for n, v in VARIANTS[f].items()}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = {key: pool.submit(build_variant, f"{key[0]}_{key[1]}", v)
                 for key, v in jobs.items()}
        libs = {f: {"committed": committed[(COMMITTED[f], ())]} for f in families}
        if "levels" in families:
            libs["levels"]["first_design"] = committed[("int8_conv3d", ())]
        for (f, n), fut in built.items():
            libs[f][n] = fut.result()
    return libs


# ---------------------------------------------------------------------------
# C entries of each family, called on one library
# ---------------------------------------------------------------------------

def _stream():
    return torch.cuda.current_stream().cuda_stream


def _entry(lib: ctypes.CDLL, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int

    def call(*args):
        err = fn(*args, _stream())
        if err:
            raise RuntimeError(f"{name} failed with {err}")
    return call


def rope_caller(lib):
    fn = _entry(lib, "rope_attention_sm90_bf16", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def call(q, k, v, cos, sin, out):
        b, length, c = q.shape
        d = c // HEADS
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
           out.data_ptr(), b, length, HEADS, d, d**-0.5, 1)
    return call


def flash_caller(lib):
    fn = _entry(lib, "flash_sm90_bf16", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    modes = {"bounded": 0, "online": 1, "single": 2}

    def call(q, k, v, mask, out, lse, mode):
        b, h, lq, d = q.shape
        strides = [x for t in (q, k, v, out) for x in fa._tma_strides(t)]
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None if mask is None else mask.data_ptr(),
           out.data_ptr(), lse.data_ptr(), b, h, lq, k.shape[2], d, *strides, 1.0, modes[mode])
    return call


def dense_caller(lib, kernel: str):
    """``flash_dense_<kernel>_sm90_bf16`` (kernel "fwd", "bwd_dkv", "bwd_dq"
    or "bwd_db") on contiguous tensors."""
    n_ptrs = {"fwd": 6, "bwd_dkv": 9}.get(kernel, 8)
    fn = _entry(lib, f"flash_dense_{kernel}_sm90_bf16", [ctypes.c_void_p] * n_ptrs
                + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    return lambda ptrs, b, h, lq, lk, group, scale: fn(*ptrs, b, h, lq, lk, group, 64, scale)


def int8_caller(lib, tile_n=None):
    """``w8a8_matmul_sm90`` at ``tile_n`` columns per tile (the wrapper's
    choice when None), bf16 out."""
    fn = _entry(lib, "w8a8_matmul_sm90", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_void_p])

    def call(x_q, x_s, w_q, w_s, bias, out):
        m, n = x_q.shape[0], w_q.shape[0]
        fn(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(), bias.data_ptr(),
           out.data_ptr(), m, n, x_q.shape[1], 0, tile_n or i8.matmul_tile_n(m, n))
    return call


def token_caller(lib, bounded: bool):
    fn = _entry(lib, "token_attention_sm90_bf16", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                + [ctypes.c_longlong] * 12 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])

    def call(q, k, v, mask, out):
        b, lq, c = q.shape
        q_strides = fa.token_major_strides(b, lq, c, HEADS)
        kv_strides = fa.token_major_strides(b, k.shape[1], c, HEADS)
        fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), b, HEADS,
           lq, k.shape[1], HEAD_DIM, *q_strides, *kv_strides, *kv_strides, *q_strides,
           HEAD_DIM**-0.5, int(bounded))
    return call


def act_caller(lib, act: str):
    fn = _entry(lib, "act_quant_sm90", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])

    def call(h, q, s):
        b, n, c2 = h.shape
        fn(h.data_ptr(), q.data_ptr(), s.data_ptr(), b * n, c2, i8.ACTIVATIONS[act])
    return call


def rmsq_caller(lib):
    fn = _entry(lib, "rms_mod_quant_sm90", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_float, ctypes.c_void_p])

    def call(x, cvec, shift, q, s):
        b, n, c = x.shape
        fn(x.data_ptr(), cvec.data_ptr(), None if shift is None else shift.data_ptr(),
           q.data_ptr(), s.data_ptr(), b, n, c, 1e-6)
    return call


def quantize_rows_caller(lib):
    fn = _entry(lib, "quantize_rows", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    return lambda x, q, s: fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), *x.shape, 0)


# ---------------------------------------------------------------------------
# Cases: {label: (calls, outputs, kernel name to time, rules)}
# ---------------------------------------------------------------------------

class Case(NamedTuple):
    calls: Dict[str, Callable[[], None]]
    outs: Dict[str, tuple]             # each call's outputs, for the rules
    match: object                      # kernel name to time, or {call: name}
    rules: Dict[str, str]              # call: "exact" or "none"


def _rules(family, names):
    return {n: VARIANTS[family][n].rule if n in VARIANTS[family] else "exact"
            for n in names if n != "committed"}


def _rows(g, *shape):
    x = torch.randn(shape, generator=g, device="cuda")
    return (x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()).bfloat16()


def rope_cases(g, libs):
    from avatar_tpu_torch.ops.rope import apply_rotary_emb_split

    rope = {n: rope_caller(lib) for n, lib in libs.items()}
    flash = flash_caller(kernel_build.load("flash_forward_sm90"))
    for b, length in ((1, 832), (8, 480), (1, 5376)):
        c = HEADS * HEAD_DIM
        q, k = _rows(g, b, length, c), _rows(g, b, length, c)
        v = torch.randn(b, length, c, generator=g, device="cuda").bfloat16()
        ang = torch.rand(b, length, c // 2, generator=g, device="cuda") * 6.3
        cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()

        def head_major(t):
            return fa.split_to_head_major(t, HEADS).reshape(
                b, length, HEADS, HEAD_DIM).transpose(1, 2).contiguous()

        qh = head_major(apply_rotary_emb_split(q, (cos, sin)))
        kh = head_major(apply_rotary_emb_split(k, (cos, sin)))
        vh = v.reshape(b, length, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
        outs = {n: (torch.empty_like(q),) for n in rope}
        outs["c_prerotated"] = (torch.empty_like(qh), torch.empty(b, HEADS, length,
                                                                  device="cuda"))
        calls = {n: (lambda fn=fn, o=outs[n]: fn(q, k, v, cos, sin, *o))
                 for n, fn in rope.items()}
        calls["c_prerotated"] = lambda o=outs["c_prerotated"]: flash(
            qh, kh, vh, None, *o, "bounded")
        rules = {**_rules("rope", rope), "c_prerotated": "none"}
        yield f"A {b}x{length}", Case(calls, outs, {**{n: "rope_sm90_kernel" for n in rope},
                                                     "c_prerotated": "flash_sm90_kernel"}, rules)


def flash_cases(g, libs):
    flash = {n: flash_caller(lib) for n, lib in libs.items()}
    cases = {"E 1x637": (1, 637, 637, False, "single"),
             "E self 8x480": (8, 480, 480, False, "single"),
             "E cross 8x480x256": (8, 480, 256, True, "single"),
             "C 1x5376": (1, 5376, 5376, False, "bounded"),
             "D 1x5376": (1, 5376, 5376, False, "online")}
    for label, (b, lq, lk, masked, mode) in cases.items():
        q, k = _rows(g, b, HEADS, lq, HEAD_DIM), _rows(g, b, HEADS, lk, HEAD_DIM)
        v = torch.randn(b, HEADS, lk, HEAD_DIM, generator=g, device="cuda").bfloat16()
        mask = None
        if masked:
            mask = torch.ones(b, lk, device="cuda")
            mask[:, 200:] = 0.0
            mask[-1] = 0.0
        runs = {n: (fn, mode) for n, fn in flash.items()}
        if mode == "single":
            runs["online"] = (flash["committed"], "online")
        outs = {n: (torch.empty_like(q), torch.empty(b, HEADS, lq, device="cuda")) for n in runs}
        calls = {n: (lambda fn=fn, m=m, o=outs[n]: fn(q, k, v, mask, *o, m))
                 for n, (fn, m) in runs.items()}
        rules = {**_rules("flash", flash), "online": "none"}
        yield label, Case(calls, outs, "flash_sm90_kernel", rules)


def dense_cases(g, libs):
    from chip_smoke import dense_cases as shapes

    for label, (q, k, v, bias, gout, scale, _) in shapes(g).items():
        bias3 = fa._dense_bias3(bias)
        b, h, lq, _ = q.shape
        dims = (b, h, lq, k.shape[2], b * h // bias3.shape[0], float(scale))
        out, lse = torch.empty_like(q), torch.empty(b, h, lq, device="cuda")
        fwd_ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias3.data_ptr(),
                    out.data_ptr(), lse.data_ptr())
        dense_caller(libs["committed"], "fwd")(fwd_ptrs, *dims)
        delta = (gout.float() * out.float()).sum(-1)
        head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), bias3.data_ptr())
        grads = {"bwd_dkv": (torch.empty_like(k), torch.empty_like(v)),
                 "bwd_dq": (torch.empty_like(q),), "bwd_db": (torch.empty_like(bias3),)}
        kernels = {"fwd": (fwd_ptrs, "fwd_keys64"),
                   **{kn: (head + tuple(t.data_ptr() for t in o), "bwd_stages2")
                      for kn, o in grads.items()}}
        for kernel, (ptrs, variant) in kernels.items():
            names = ("committed", variant)
            calls = {n: (lambda fn=dense_caller(libs[n], kernel), p=ptrs: fn(p, *dims))
                     for n in names}
            yield f"G {label} {kernel}", Case(calls, {}, f"flash_dense_{kernel}_sm90_kernel",
                                              _rules("dense", names))
        torch.cuda.empty_cache()


def int8_cases(g, libs):
    for m, k, n in I8_SHAPES:
        x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        x_s = torch.rand(m, 1, generator=g, device="cuda") * 1e-2 + 1e-3
        w_s = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-4
        bias = torch.randn(n, generator=g, device="cuda")
        fns = {**{name: int8_caller(lib) for name, lib in libs.items()},
               "tile128": int8_caller(libs["committed"], 128),
               "tile256": int8_caller(libs["committed"], 256)}
        outs = {name: (torch.empty(m, n, device="cuda", dtype=torch.bfloat16),) for name in fns}
        calls = {name: (lambda fn=fn, o=outs[name]: fn(x_q, x_s, w_q, w_s, bias, *o))
                 for name, fn in fns.items()}
        yield f"H {m}x{k}x{n}", Case(calls, outs, "w8a8_sm90_kernel", _rules("int8", fns))


def token_cases(g, libs):
    from chip_smoke import CAPTION, TOKEN_SHAPES, WIDTH

    for label, (b, lq, kept) in TOKEN_SHAPES.items():
        x = _rows(g, b, lq + 2 * CAPTION, WIDTH)
        q, k, v = (t.contiguous() for t in x.split([lq, CAPTION, CAPTION], dim=1))
        mask = torch.ones(b, CAPTION, device="cuda")
        for i, n in enumerate(kept):
            mask[i, n:] = 0.0
        for bounded in (True, False):
            if not bounded and label not in ("832x256", "train 8x480x256"):
                continue
            outs = {n: (torch.empty_like(q),) for n in libs}
            calls = {n: (lambda fn=token_caller(lib, bounded), o=outs[n]: fn(q, k, v, mask, *o))
                     for n, lib in libs.items()}
            yield f"B {label}, bounded={bounded}", Case(calls, outs, "token_sm90_kernel",
                                                        _rules("token", libs))


def act_cases(g, libs):
    h = (2.0 * torch.randn(1, 5376, 8192, generator=g, device="cuda")).bfloat16()
    for act in i8.ACTIVATIONS:
        width = 4096 if act == "geglu" else 8192
        outs = {n: (torch.empty(5376, width, device="cuda", dtype=torch.int8),
                    torch.empty(5376, 1, device="cuda")) for n in libs}
        calls = {n: (lambda fn=act_caller(lib, act), o=outs[n]: fn(h, *o))
                 for n, lib in libs.items()}
        yield f"K {act}", Case(calls, outs, "act_quant_regs_kernel", _rules("act", libs))


def rmsq_cases(g, libs):
    from chip_smoke import LONG_TOKENS, WIDTH

    x = torch.randn(1, LONG_TOKENS, WIDTH, generator=g, device="cuda").bfloat16()
    cvec = 1.0 + 0.3 * torch.randn(1, WIDTH, generator=g, device="cuda")
    shift = 0.2 * torch.randn(1, WIDTH, generator=g, device="cuda")

    def outs_of(names):
        return {n: (torch.empty(LONG_TOKENS, WIDTH, device="cuda", dtype=torch.int8),
                    torch.empty(LONG_TOKENS, 1, device="cuda")) for n in names}

    fns = {n: rmsq_caller(lib) for n, lib in libs.items() if n != "i_on_j"}
    for label, sh in (("shift", shift), ("no shift", None)):
        outs = outs_of(fns)
        calls = {n: (lambda fn=fn, o=outs[n], sh=sh: fn(x, cvec, sh, *o))
                 for n, fn in fns.items()}
        yield f"J [1, {LONG_TOKENS}, {WIDTH}], {label}", Case(
            calls, outs, "rms_mod_quant_regs_kernel", _rules("rmsq", fns))
    # I's function on J's kernel, against the committed I
    i_fn, j_fn = quantize_rows_caller(libs["committed"]), rmsq_caller(libs["i_on_j"])
    outs = outs_of(("committed", "i_on_j"))
    calls = {"committed": lambda: i_fn(x[0], *outs["committed"]),
             "i_on_j": lambda: j_fn(x, cvec, None, *outs["i_on_j"])}
    yield f"I [{LONG_TOKENS}, {WIDTH}], committed I against i_on_j", Case(
        calls, outs, {"committed": "quantize_rows_kernel",
                      "i_on_j": "rms_mod_quant_regs_kernel"}, {"i_on_j": "exact"})


def levels_caller(lib):
    """L1 through its C entry (the first design's on ``first_design``)."""
    name = ("int8_conv3d_quant_sm90" if hasattr(lib, "int8_conv3d_quant_sm90")
            else "int8_conv3d_quant")
    fn = _entry(lib, name, [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p])

    def call(x, s, xq):
        b, c = x.shape[:2]
        fn(x.data_ptr(), s.data_ptr(), xq.data_ptr(), b, c, x[0, 0].numel(), xq.shape[-1], 0)
    return call


def levels_cases(g, libs):
    from avatar_tpu_torch.ops import causal_conv3d as cc

    for shape in ((1, 128, 97, 64, 64), (1, 48, 97, 64, 64), (1, 256, 49, 32, 32)):
        x = torch.randn(shape, generator=g, device="cuda").bfloat16()
        s = cc.act_scale(x)
        cp = cc.padded_channels(shape[1])
        outs = {n: (torch.empty((1, *shape[2:], cp), device="cuda", dtype=torch.int8),)
                for n in libs}
        calls = {n: (lambda fn=levels_caller(lib), o=outs[n]: fn(x, s, *o))
                 for n, lib in libs.items()}
        # a copy of half L1's bytes each way: as many bytes read and written
        half = (x.numel() * 2 + outs["committed"][0].numel()) // 2
        src = torch.empty(half, device="cuda", dtype=torch.uint8)
        dst = torch.empty_like(src)
        calls["copy"] = lambda: dst.copy_(src)
        outs["copy"] = (dst,)
        rules = {n: "exact" for n in libs if n != "committed"}
        rules["copy"] = "none"
        match = {n: "quant_levels_kernel" for n in libs}
        match["first_design"] = "quant_relayout_kernel"
        match["copy"] = ""
        yield f"L1 {list(shape)}", Case(calls, outs, match, rules)


CASES = {"rope": rope_cases, "flash": flash_cases, "dense": dense_cases, "int8": int8_cases,
         "token": token_cases, "act": act_cases, "rmsq": rmsq_cases,
         "levels": levels_cases}


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

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


def run_case(label: str, case: Case) -> dict:
    """Every call once, each held to its rule against the committed call's
    outputs; then {call: [ms, ms]} in turns: the committed call first and
    last, the others twice in the middle."""
    for fn in case.calls.values():
        fn()
    torch.cuda.synchronize()
    for name, rule in case.rules.items():
        if rule == "exact" and not all(
                torch.equal(a, b) for a, b in zip(case.outs[name], case.outs["committed"])):
            raise RuntimeError(f"{label}: {name} differs from the committed kernel")
    names = [n for n in case.calls if n != "committed"]
    times: dict = {}
    for name in ["committed"] + names + names[::-1] + ["committed"]:
        match = case.match[name] if isinstance(case.match, dict) else case.match
        times.setdefault(name, []).append(device_ms(case.calls[name], match))
    return times


def main(argv=None) -> int:
    families = list(argv if argv is not None else sys.argv[1:]) or list(CASES)
    unknown = [f for f in families if f not in CASES]
    if unknown:
        print(f"kernel_ab: unknown families {unknown}; known: {list(CASES)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    libs = build_libs(families)
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for family in families:
        for label, case in CASES[family](g, libs[family]):
            result[label] = run_case(label, case)
    print(smi, flush=True)
    print(json.dumps({"card": smi, "ms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

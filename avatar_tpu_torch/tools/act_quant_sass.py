"""Instructions per output element of kernel K (the FF activation and int8
row quantization of ``csrc/row_quant.cu``), counted from the SASS that
``nvcc`` built, and the issue bound they give on this card; and the same
count for kernel L1 (the W8A8 VAE's levels, ``csrc/int8_conv3d_sm90.cu``)
per input element, from ``tools/conv_quant_work.cu``
(:func:`count_level_work`).

    python3 -m avatar_tpu_torch.tools.act_quant_sass [--dump DIR]

The bound counts the work the function needs, apart from any kernel of
it: ``tools/act_quant_work.cu`` holds, for each activation (gelu-approximate,
gelu, geglu), a loop of one element per iteration doing that work (the
bf16 conversion, the activation as ``row_quant.cu`` compiles it, max|y|,
the multiply and one rounding conversion) and the same loop with the raw
bits folded in instead; the difference of the two loop bodies
(:func:`count_work`) is the work per output element. Instructions the
compiler placed out of line and branches back into the loop count too.

As diagnostics beside it, the tool builds ``csrc/row_quant.cu``
(``ops/kernel_build.py``), disassembles it with ``cuobjdump -sass`` and
counts the instructions of both act_quant kernels over rows of the DiT's
FF width, 8,192 (geglu's output row is half of it):

- ``act_quant_regs_kernel`` (the Hopper route, ``act_quant_sm90``) in the
  instantiation that width takes (:func:`regs_chunks`: 256 threads a row
  of 4 chunks of 8 values each; geglu 2): it has no loop, so its static
  count over a thread's elements (32; geglu 16) is the count per element,
  the row's reduction and scale included;
- ``act_quant_kernel`` (the row-block route) in bf16: its three loops
  (load and activation, max|y| from shared memory, quantize and store),
  each over the elements a thread takes with a stride of 256. Each loop's
  body is counted over the elements one pass of it covers (its loads or
  stores of one element each), the main loop of each phase (phases end at
  a ``BAR``), and the instructions outside the loops over the elements of
  a thread.

Every instruction counts, both sides of each branch of ``tanhf`` and
``erff`` included (with the DiT's data both sides run in every warp), the
``NOP`` padding and the closing self-branch excepted. The issue bound:
an SM issues at most four warp instructions per clock (one per scheduler),
so ``count x elements / (SMs x 4 x 32 x max SM clock)``. Prints one JSON
object; ``--dump DIR`` also writes both libraries' whole SASS into DIR.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

ACTIVATIONS = {"gelu-approximate": 0, "gelu": 1, "geglu": 2}
# the DiT's FF activation width (K's input row) and the long path's rows
WIDTH, ROWS = 8192, 5376
THREADS = 256  # threads a row of both kernels
INSTRUCTIONS_PER_CLOCK = 4 * 32  # thread instructions per clock per SM

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z0-9_.]+)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")


def sass(lib: Path, dump: Path = None) -> Dict[str, List[Tuple[int, str, str]]]:
    """:func:`parse_sass` of a built library's ``cuobjdump -sass`` (whose
    whole output goes to ``dump / "<library>.sass"`` with ``dump``)."""
    from avatar_tpu_torch.ops.kernel_build import nvcc_path

    tool = Path(nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    if dump is not None:
        dump.mkdir(parents=True, exist_ok=True)
        (dump / f"{lib.stem}.sass").write_text(text)
    return parse_sass(text)


def parse_sass(text: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """{mangled function name: [(address, opcode, operands), ...]} of
    ``cuobjdump -sass`` output."""
    out: Dict[str, List[Tuple[int, str, str]]] = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
            continue
        m = _INSTR.search(line)
        if m and name is not None:
            out[name].append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return out


def _body(instrs):
    """The executable instructions: up to the closing self-branch, NOPs
    dropped."""
    body = []
    for addr, op, args in instrs:
        t = _TARGET.search(args)
        if op == "BRA" and t and int(t.group(1), 16) == addr:
            break
        if op != "NOP":
            body.append((addr, op, args))
    return body


def _elements(ops: List[str]) -> int:
    """Elements one pass of a row-block loop covers: its loads or stores of
    one element each (global loads in the activation loop, shared loads in
    the max loop, global byte stores in the quantize loop)."""
    return max(sum(op.startswith(kind) for op in ops)
               for kind in ("LDG", "LDS", "STG", "STS"))


def count_straight(instrs, per_thread: int) -> dict:
    body = _body(instrs)
    return {"instructions": len(body), "elements_per_thread": per_thread,
            "per_element": len(body) / per_thread}


def count_loops(instrs, per_thread: int) -> dict:
    """Per element: each phase's main loop body over its elements per pass,
    plus every instruction outside the loops over ``per_thread``."""
    body = _body(instrs)
    index = {addr: i for i, (addr, _, _) in enumerate(body)}
    loops = []
    for i, (addr, op, args) in enumerate(body):
        t = _TARGET.search(args)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            start = index.get(int(t.group(1), 16))
            if start is not None:
                ops = [o for _, o, _ in body[start:i + 1]]
                loops.append({"start": start, "end": i, "length": len(ops),
                              "elements": _elements(ops)})
    bars = [i for i, (_, op, _) in enumerate(body) if op.startswith("BAR")]
    phases: Dict[int, dict] = {}
    for lp in loops:
        phase = sum(b < lp["start"] for b in bars)
        best = phases.get(phase)
        if lp["elements"] and (best is None or lp["elements"] > best["elements"]):
            phases[phase] = lp
    in_loops = set()
    for lp in loops:
        in_loops.update(range(lp["start"], lp["end"] + 1))
    outside = len(body) - len(in_loops)
    per_element = sum(lp["length"] / lp["elements"] for lp in phases.values())
    return {"instructions": len(body), "loops": [
                {k: lp[k] for k in ("length", "elements")} for lp in loops],
            "main_loops": [{"length": lp["length"], "elements": lp["elements"]}
                           for _, lp in sorted(phases.items())],
            "outside_loops": outside, "elements_per_thread": per_thread,
            "per_element": per_element + outside / per_thread}


def _loop_length(body, calls: bool = False) -> int:
    """Instructions of the longest loop of ``body`` (from a backward branch's
    target to that branch), with any block the loop branches out to that
    branches back into it (code the compiler placed out of line). A call in
    the loop raises, unless ``calls``: then it counts as one instruction and
    its subroutine (a slow path, such as the division's for flagged
    operands) is not walked."""
    index = {addr: i for i, (addr, _, _) in enumerate(body)}
    best = None
    for i, (addr, op, args) in enumerate(body):
        t = _TARGET.search(args)
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            start = index.get(int(t.group(1), 16))
            if start is not None and (best is None or i - start > best[1] - best[0]):
                best = (start, i)
    if best is None:
        raise RuntimeError("no loop in the SASS")
    start, end = best
    addrs = {body[j][0] for j in range(start, end + 1)}
    length = end - start + 1
    for j in range(start, end + 1):
        op, args = body[j][1], body[j][2]
        if op.startswith("CALL") and not calls:
            raise RuntimeError(f"a call in the counted loop: {op} {args}")
        t = _TARGET.search(args)
        if not (op.startswith("BRA") and t and index.get(int(t.group(1), 16), -1) > end):
            continue
        for k in range(index[int(t.group(1), 16)], len(body)):
            k_op, k_args = body[k][1], body[k][2]
            if k_op.startswith("EXIT") or k_op.startswith("RET"):
                break
            kt = _TARGET.search(k_args)
            if k_op.startswith("BRA") and kt and int(kt.group(1), 16) in addrs:
                length += k - index[int(t.group(1), 16)] + 1
                break
    return length


def _work_sass(source_name: str, dump: Path = None):
    """:func:`sass` of ``tools/<source_name>``, built with the kernels' own
    nvcc flags."""
    from avatar_tpu_torch.ops import kernel_build

    source = Path(__file__).with_name(source_name)
    lib = kernel_build.BUILD_DIR / f"{source.stem}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [kernel_build.nvcc_path(), *kernel_build.NVCC_FLAGS, "-I", str(kernel_build.CSRC),
           "-o", str(lib), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source.name}:\n{proc.stdout}")
    return sass(lib, dump)


def _work_pair(funcs, pattern: str, calls: bool = False) -> dict:
    """{"work": n, "frame": n, "per_element": n - frame} of the two loop
    kernels whose mangled names hold ``pattern`` with the flag 1 and 0."""
    counts = {}
    for label, flag in (("work", 1), ("frame", 0)):
        names = [n for n in funcs if pattern.format(flag=flag) in n]
        if len(names) != 1:
            raise RuntimeError(f"{pattern} ({label}) not found in the SASS: {names}")
        counts[label] = _loop_length(_body(funcs[names[0]]), calls)
    return {**counts, "per_element": counts["work"] - counts["frame"]}


def count_work(dump: Path = None) -> dict:
    """{activation: {"work": n, "frame": n, "per_element": n - frame}}: the
    loop bodies of ``act_work<act, true>`` and ``act_work<act, false>`` of
    ``tools/act_quant_work.cu``, built with the kernels' own nvcc flags."""
    funcs = _work_sass("act_quant_work.cu", dump)
    return {act: _work_pair(funcs, f"act_workILi{code}ELb{{flag}}E")
            for act, code in ACTIVATIONS.items()}


# the mangled template arguments of level_work's input types
LEVEL_TYPES = {"bf16": "13__nv_bfloat16", "f32": "f"}


def count_level_work(dump: Path = None) -> dict:
    """{"bf16" | "f32": {"work": n, "frame": n, "per_element": n - frame}}:
    kernel L1's work per input element, the loop bodies of
    ``level_work<InT, true>`` and ``level_work<InT, false>`` of
    ``tools/conv_quant_work.cu`` (the division's slow-path call counted as
    one instruction, its subroutine not)."""
    funcs = _work_sass("conv_quant_work.cu", dump)
    return {name: _work_pair(funcs, f"level_workI{mangled}Lb{{flag}}E", calls=True)
            for name, mangled in LEVEL_TYPES.items()}


def out_width(act: str, in_width: int = WIDTH) -> int:
    return in_width // 2 if act == "geglu" else in_width


def regs_chunks(width: int) -> int:
    """Chunks of 8 per thread of act_quant_regs_kernel for an output row
    of ``width``, as ``dispatch_regs`` picks them: the least power of two
    that covers the row."""
    return 1 << (-(-width // (8 * THREADS)) - 1).bit_length()


def count_act_quant(dump: Path = None) -> dict:
    """{activation: {"sm90": ..., "rowblock": ...}} instruction counts per
    output element over input rows of WIDTH (see the module's docstring)."""
    from avatar_tpu_torch.ops import kernel_build

    kernel_build.load("row_quant")
    funcs = sass(kernel_build._lib_path("row_quant"), dump)
    result = {}
    for act, code in ACTIVATIONS.items():
        regs = [n for n in funcs
                if f"act_quant_regs_kernelILi{code}ELi{regs_chunks(out_width(act))}E" in n]
        block = [n for n in funcs if "16act_quant_kernel" in n
                 and f"I13__nv_bfloat16Li{code}E" in n]
        if len(regs) != 1 or len(block) != 1:
            raise RuntimeError(f"act_quant kernels of {act} not found in the SASS: "
                               f"{regs} {block}")
        per_thread = out_width(act) // THREADS
        result[act] = {"sm90": count_straight(funcs[regs[0]], per_thread),
                       "rowblock": count_loops(funcs[block[0]], per_thread)}
    return result


def issue_bound_ms(per_element: float, elements: int, sms: int, clock_mhz: float) -> float:
    """The least time in ms to issue ``per_element`` instructions for each
    of ``elements`` at four warp instructions per clock per SM."""
    return per_element * elements / (sms * INSTRUCTIONS_PER_CLOCK * clock_mhz * 1e6) * 1e3


def max_sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dump", type=Path, default=None,
                        help="write the library's SASS into this directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("act_quant_sass: needs the card (its SM count and clock)")
    work = count_work(args.dump)
    levels = count_level_work(args.dump)
    counts = count_act_quant(args.dump)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_mhz()
    for act in ACTIVATIONS:
        for res in (work[act], *counts[act].values()):
            res["issue_bound_ms"] = issue_bound_ms(res["per_element"],
                                                   out_width(act) * ROWS, sms, clock)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "sms": sms,
                      "max_sm_clock_mhz": clock, "shape": [ROWS, WIDTH],
                      "work": work, "kernels": counts, "l1_levels_work": levels}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

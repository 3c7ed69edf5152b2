"""The long W8A8 path of ``chip_smoke.py`` alone, and the host cost of the
row-quant wrappers I and J, in this checkout, on one card.

    python3 <checkout>/avatar_tpu_torch/tools/w8a8_path.py TAG

It runs the checkout it is started from (the working directory: its
package, and ``chip_smoke.py``'s path and launch expectations), so one
copy of it drives an older checkout too. To compare two commits on one
card, unpack both and run it from each in turns in one call: parent,
change, change, parent.
Prints one JSON line of J's and I's host microseconds per call (5 batches
of 100 calls, no synchronize inside a batch), device ms (torch.profiler)
and CUDA-event ms per call at ``[1, 5376, 2048]`` with J's ``cvec`` and
``shift`` as the DiT passes them (bf16, the shift a strided view), then
``chip_smoke.run_pipeline``'s lines for one 161-frame 512 px W8A8 video
(seconds, step ms, and a profile of 3 steps: device busy ms and idle
share). Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


def main(argv=None) -> int:
    tag = (argv if argv is not None else sys.argv[1:] or ["this"])[0]
    if not torch.cuda.is_available():
        print("w8a8_path: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from avatar_tpu_torch.ops import int8_matmul as i8
    from avatar_tpu_torch.ops import kernel_build
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    kernel_build.build_all(["row_quant", "int8_matmul_sm90", "flash_forward_sm90",
                            "token_attention_sm90"])
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(1, 5376, 2048, generator=g, device="cuda").bfloat16()
    ada = torch.randn(1, 1, 6, 2048, generator=g, device="cuda").bfloat16()
    cvec, shift = 1.0 + ada[:, :, 1], ada[:, :, 0]
    res = {"tree": tag}
    for name, fn in (("j", lambda: i8.fused_rms_mod_quant(x, cvec, shift)),
                     ("i", lambda: i8.quantize_rows_pallas(x[0]))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(100):
                fn()
            host.append((time.perf_counter() - t0) / 100 * 1e6)
            torch.cuda.synchronize()
        res[f"{name}_host_us"] = sorted(host)
        res[f"{name}_device_ms"] = cs.device_ms(
            fn, "rms_mod_quant" if name == "j" else "quantize_rows")
        res[f"{name}_events_ms"] = cs.time_ms(fn)
    print(json.dumps(res), flush=True)
    pipe, _ = cs.make_full_pipeline()
    w8 = LTXVideoPipeline(pipe.dit_cfg, pipe.raw_dit_params, pipe.vae_cfg, pipe.vae_params,
                          quantize_weights="w8a8", device="cuda")
    every = cs.LAYERS * cs.STEPS
    expect = {"w8a8_matmul": 8 * every, "w8a8_matmul_sm90": 8 * every,
              "quantize_rows": 3 * every, "rms_mod_quant": 2 * every, "act_quant": every,
              "act_quant_sm90": every, "flash_bounded": every, "flash_bounded_sm90": every,
              "fused_token_attention": every, "fused_token_attention_sm90": every}
    if "rms_mod_quant_sm90" in i8.launch_counts:  # a checkout with J's two routes
        expect["rms_mod_quant_sm90"] = 2 * every
    cs.run_pipeline(w8, f"w8a8_{tag}", 512, 161,
                    dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0), expect, 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""int8.roofline.render: the least time of the int8 layer's work in one
video (H, I, J and K in every DiT forward, L1 and L2 in every W8A8 conv of
the encodes and the decode, work.py) over the device time of those kernels
in the traced video."""

PATTERNS = ("w8a8", "quantize_rows", "rms_mod_quant", "act_quant", "quant_levels",
            "quant_relayout", "int8_conv3d", "conv_sm90")


def read(rec):
    if rec.trace is None or rec.work is None or "int8" not in rec.work.least:
        return None
    seconds = rec.trace.seconds_matching(PATTERNS)
    return 100.0 * rec.work.least["int8"] / seconds if seconds else None

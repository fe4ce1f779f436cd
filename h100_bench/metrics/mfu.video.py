"""The video step's share of the card's bf16 peak: the counted operations
of every window position run in the window before the traced slice (32
a window, carried and padded positions included: the encoder, the DPT
head and the four motion modules, ``counts_vda.window_flops``), over
those seconds times 989 TFLOP/s, in percent."""

from h100_bench import counts, counts_vda


def read(run):
    pre = run.extra.get("pre")
    if not pre or not pre["units"]:
        return None
    flops = counts_vda.window_flops(run.config, run.net_hw)
    return (100.0 * flops * pre["units"]
            / (pre["seconds"] * counts.PEAK_BF16_FLOPS))

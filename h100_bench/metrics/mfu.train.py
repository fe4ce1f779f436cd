"""The training step's share of the card's bf16 peak: three times the
counted forward operations (``counts.forward_flops``: forward, and the
backward's two products per forward product; the checkpointed blocks'
recompute is not counted) of the frames of the steps finished in the
window before the traced step, over those seconds times 989 TFLOP/s, in
percent."""

from h100_bench import counts


def read(run):
    pre = run.extra.get("pre")
    if not pre or not pre["frames"]:
        return None
    flops = 3 * counts.forward_flops(run.config, run.net_hw)
    return (100.0 * flops * pre["frames"]
            / (pre["seconds"] * counts.PEAK_BF16_FLOPS))

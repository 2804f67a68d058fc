"""The share of the traced segment in which nothing ran on the device
(no kernel, copy or memset): 1 - busy / window, in percent."""
LAYER = "device (H100)"
UNIT = "%"
MOVES = "qps"
SOURCE = "device_trace"


def read(ctx):
    prof = ctx["profile"]
    if prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])

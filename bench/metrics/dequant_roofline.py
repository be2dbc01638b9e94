"""dequant's least time over its device time, for the expert slices
decoded in decode dispatches, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return roofline(rec, "dequant", "decode_dispatch")

"""paged_flash_decode's least time over its device time, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return roofline(rec, "attn_decode", "decode_dispatch")

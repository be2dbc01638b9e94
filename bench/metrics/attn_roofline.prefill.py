"""paged_flash_prefill's least time over its device time, in percent."""

from bench.metrics._lib import *  # noqa: F401,F403


def read(rec):
    return roofline(rec, "attn_prefill", "prefill")

from .hw import H100_SXM  # noqa: F401
from .analysis import (collective_stats, roofline_terms, model_flops,
                       summarize_cell)  # noqa: F401

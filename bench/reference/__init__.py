"""Plain PyTorch references of the benchmark's configurations, and the
comparison that decides whether a run's served tokens are correct.

Nothing here imports the program under test: each reference draws its
weights again from the run's seed (``weights``), puts them on their
served formats itself (``codecs``) and computes in float32 with TF32
off.  A configuration names its reference module (``llama``, ``jamba``)
in its file's ``reference`` key."""

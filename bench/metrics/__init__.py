"""One reader per metric, ``<metric>.py`` with ``read(record)``."""

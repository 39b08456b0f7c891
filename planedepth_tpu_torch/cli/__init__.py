"""Command-line entry points: ``train``, ``evaluate`` (``options``: the flags)."""

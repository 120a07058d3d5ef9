"""Persistence helpers of the port (copies of the reference's
``repro/store_io`` pieces it needs)."""

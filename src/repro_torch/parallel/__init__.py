"""Frontier primitives of the search loop (stable key sort, rank merge)."""

"""Exact-graph helpers and the batched search engine of the port."""

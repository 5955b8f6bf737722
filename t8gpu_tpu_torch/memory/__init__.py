"""Subgrid block descriptor and element-capacity buckets."""

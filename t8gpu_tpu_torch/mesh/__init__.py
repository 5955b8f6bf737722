"""Host-side forest and the subgrid neighbor tables."""

"""L6: homology statistics, scoring, islands/backbone, distance matrices."""

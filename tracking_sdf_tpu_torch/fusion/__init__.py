"""TSDF fusion: the dense reference pass and the flat bricked path."""

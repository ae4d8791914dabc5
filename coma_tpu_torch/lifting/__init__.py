"""3D lifting (stage 2): orthographic cameras, the silhouette rasterizer,
depth initialisation, RANSAC triangulation, batched depth optimisation and
the sample metrics."""

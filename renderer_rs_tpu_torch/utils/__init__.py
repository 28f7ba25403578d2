"""Host utilities: procedural meshes, image reading and writing."""

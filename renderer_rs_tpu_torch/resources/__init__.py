"""Resources: meshes and glTF models, materials, textures, Radiance .hdr
images, uniform buffers."""

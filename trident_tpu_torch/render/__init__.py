"""Scene → frame: types, camera, lights, textures, draw gathering, renderer."""

"""Raw scenes, one loader module per ``scene.loader`` name of a
configuration file, found by that name.

``load(scene, root) -> dict`` returns what both sides are handed:
``materials`` (a list of {mtype, albedo, emission, emission_strength,
roughness, metallic}; mtype 0 metal, 2 Lambertian), ``vertices`` (V, 3)
float32, ``indices`` (3T,) int32, ``normals`` (V, 3) or None,
``tri_material`` (T,) int32, ``spheres`` (a list of {position, radius,
material}) and ``camera`` ({position, yaw, pitch, fov}, degrees).
"""

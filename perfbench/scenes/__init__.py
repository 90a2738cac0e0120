"""Raw scenes, one loader module per ``scene.loader`` name of a
configuration file, found by that name.

``load(scene, root) -> dict`` returns what both sides are handed:
``materials``, ``vertices`` (V, 3) float32, ``indices`` (3T,) int32,
``normals`` (V, 3) or None, ``tri_material`` (T,) int32, ``spheres`` (a
list of {position, radius, material}) and ``camera`` ({position, yaw,
pitch, fov}, degrees).

``materials`` is a list of dictionaries with the fields of the program's
``SceneBuilder.add_material``, each passed through as it stands
(perfbench/program.py); a field left out takes the builder's default:
``mtype`` (0 metal, 1 dielectric, 2 Lambertian, 3 GGX; default 0),
``albedo`` (3 floats; 0), ``emission`` (3 floats; 0),
``emission_strength`` (0), ``metallic`` (0), ``roughness`` (0),
``absorption`` (3 floats; 0), ``absorption_strength`` (1) and ``ior`` (1).
Which of them a configuration's reference covers, its ``covers`` says
(perfbench/reference/__init__.py).
"""

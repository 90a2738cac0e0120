"""Plain references of the benchmark's configurations, one module each.

A configuration file (perfbench/configs/<name>.json) may carry
``"reference": "<module>"``, the name of a Python module in this package;
without the key its reference is ``transport``.  ``perfbench.harness.
reference_module`` finds the module by that name and keeps it on the run's
``Ctx``; the loops and the calibration call it only through ``ctx.reference``.
So a configuration that the existing references do not cover comes with a
module of its own, a new file here, and the configuration names it.
``post`` is not such a module: it is the post-processing that every serving
check shares.

A reference module is plain PyTorch or NumPy.  It imports nothing of the
measured package and takes nothing the program made: it is handed the raw
scene (perfbench/scenes) and the configuration's ``render`` dictionary,
which the program is handed too.  It has these functions:

- ``covers(raw, render) -> str | None``: the reason why the configuration
  lies outside the reference, or None.  The harness calls it while it
  builds the run's context, before the program is built, and refuses a
  configuration with a reason; it looks at the raw material list and the
  render dictionary only, in plain Python.
- ``prepare(raw, device, dtype=torch.float32) -> scene``: the reference's
  own tensors of a raw scene.  ``dtype`` is the float type of the whole
  computation: torch.bfloat16 gives the control that perfbench/calibrate.py
  reads.
- ``with_material(scene, index, **fields) -> scene`` and
  ``with_camera(scene, **fields) -> scene``: the scene after an editor's
  edit of one material row or of the camera.
- ``render_frame(scene, render, frame) -> (H, W, 3)``: one frame, where
  ``frame`` is the count of frames since the last reset, without grad.
- ``accumulate(old, new, frame_count) -> image``: the running mean of the
  frames since the last reset.
- ``exact_matmuls()``: a context manager that every call above runs in.
- ``loss_grad(scene, render, frame, trainable) -> (loss, {leaf: grad})``:
  the bench loss and its grads; only the training loop calls it.
"""

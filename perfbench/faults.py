"""Faults planted under the timed path, for the tests that must see
``correct`` come out false and for the calibration of the limits
(perfbench/calibrate.py).  A benchmark run never imports this module.

- ``stale``: a step that returns its state unchanged (training: the
  previous step's loss and grads; serving: the accumulated image as it
  was);
- ``half``: half of the batch left out (training: the top half of the
  rows, the mean taken over them; serving: the lower half of each frame
  not rendered);
- ``altered``: an answer altered where it is produced (training: the
  largest grad entry of the first non-zero leaf negated; serving: a 16 x
  16 tile of each frame raised by 0.5);
- ``no_exchange``: the sum over the ranks left out (each rank keeps its
  own band's loss and grads).
"""

from __future__ import annotations

FAULTS = ("stale", "half", "altered", "no_exchange")


def apply(name: str):
    """Plant fault ``name`` -> a function that takes it out again."""
    from wc_path_tracer_tpu_torch.parallel import render as prender
    from wc_path_tracer_tpu_torch.render import golden

    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; faults: {FAULTS}")
    saved = (prender._all_reduce, prender.sharded_scene_loss_grad,
             golden.render_step)

    def restore():
        (prender._all_reduce, prender.sharded_scene_loss_grad,
         golden.render_step) = saved

    if name == "no_exchange":
        prender._all_reduce = lambda t, group: t
        return restore
    orig_loss_grad = prender.sharded_scene_loss_grad

    def loss_grad(cfg, trainable, renderer="golden", group=None):
        if name == "half":
            fn = orig_loss_grad(cfg.replace(height=cfg.height // 2),
                                trainable, renderer, group)
            return lambda s, c, f, target: fn(s, c, f,
                                              target[:cfg.height // 2])
        fn = orig_loss_grad(cfg, trainable, renderer, group)
        prev = {}

        def faulty(*args):
            loss, grads = fn(*args)
            if name == "stale":
                out = prev.get("out", (loss, grads))
                prev["out"] = (loss, grads)
                return out
            grads = dict(grads)
            k = next(k for k, g in grads.items() if bool(g.abs().sum() > 0))
            g = grads[k].clone()
            flat = g.view(-1)
            i = int(flat.abs().argmax())
            flat[i] = -flat[i]
            grads[k] = g
            return loss, grads
        return faulty

    def render_step(scene, mats, cfg, frame_count, old_image, frame_fn=None):
        if name == "stale":
            return old_image
        frame = frame_fn(scene, mats, cfg, frame_count).clone()
        if name == "half":
            frame[cfg.height // 2:] = 0.0
        else:
            frame[:16, :16] += 0.5
        return golden.accumulate(old_image, frame, frame_count)

    prender.sharded_scene_loss_grad = loss_grad
    golden.render_step = render_step
    return restore

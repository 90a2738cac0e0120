"""Command-line interface (port of the JAX package's cli.py).

    python -m wc_path_tracer_tpu_torch render --scene cornell --nee \
        --frames 16 --out cornell.png
    python -m wc_path_tracer_tpu_torch render --gltf assets/bunny.glb \
        --frames 8 --bloom --out bunny.png
    python -m wc_path_tracer_tpu_torch invert --steps 100 --out-dir inv
    python -m wc_path_tracer_tpu_torch info

Every command runs on the CUDA card unless ``--device`` names another
(``--device cpu``); without a card it exits with an error.  Started as a
rank of a process group (``torchrun`` sets WORLD_SIZE, RANK, LOCAL_RANK
and the master address), ``invert`` trains over the group with the backend
``--backend`` names; ``--device cuda`` then means the rank's own card,
``cuda:LOCAL_RANK``.  ``render`` runs in one process and refuses such a
launch.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
import torch.distributed as dist


def _add_render_args(p):
    p.add_argument("--scene", default="default",
                   choices=["default", "cornell", "triangle", "bunny"])
    p.add_argument("--obj", help="render an OBJ file instead of a builtin scene")
    p.add_argument("--gltf", help="render a glTF file instead of a builtin scene")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--nee", action="store_true", help="next-event estimation")
    p.add_argument("--mis", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="balance-heuristic MIS under NEE (--no-mis restores "
                        "the skip-emission-after-NEE estimator)")
    p.add_argument("--rr", action="store_true", help="Russian roulette")
    p.add_argument("--jitter", action="store_true", help="subpixel AA jitter")
    p.add_argument("--edge-grads", action="store_true",
                   help="silhouette (visibility) gradients via the coverage "
                        "estimator; also antialiases sphere edges (~2x cost)")
    p.add_argument("--compact", action="store_true",
                   help="alive-ray stream compaction between bounces")
    p.add_argument("--true-dielectric", action="store_true",
                   help="fix reference quirk 3: glass renders as dielectric")
    p.add_argument("--renderer", default="auto",
                   choices=["auto", "golden", "sweep", "wavefront", "pallas"],
                   help="closest-hit backend: auto picks brute force up to "
                        "256 triangle slots, the cluster sweep above")
    p.add_argument("--bloom", action="store_true",
                   help="bloom post pass (ref ships bloom.comp but never "
                        "dispatches it)")
    p.add_argument("--bloom-threshold", type=float, default=1.0)
    p.add_argument("--bloom-knee", type=float, default=0.1)
    p.add_argument("--bloom-strength", type=float, default=1.0)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs every kernel's plain twin)")


def _build_scene(args, device):
    from wc_path_tracer_tpu_torch.models import builtin
    if args.obj:
        return builtin.mesh_scene(args.obj, device=device)
    if args.gltf:
        from wc_path_tracer_tpu_torch.models.gltf import gltf_scene
        return gltf_scene(args.gltf, device=device)
    if args.scene == "cornell":
        return builtin.cornell_box_scene(device=device)
    if args.scene == "triangle":
        return builtin.single_triangle_scene(device=device)
    if args.scene == "bunny":
        from wc_path_tracer_tpu_torch.models.procedural import bunny_like_scene
        return bunny_like_scene(device=device)
    return (builtin.default_scene(true_dielectric=args.true_dielectric,
                                  device=device),
            builtin.default_camera(device=device))


def _make_cfg(args, sky):
    from wc_path_tracer_tpu_torch.utils.config import RenderConfig
    return RenderConfig(width=args.width, height=args.height,
                        samples=args.samples, max_bounces=args.bounces,
                        sky=sky, use_nee=args.nee, mis=args.mis,
                        use_rr=args.rr, pixel_jitter=args.jitter,
                        edge_grads=args.edge_grads, compact=args.compact,
                        bloom=args.bloom,
                        bloom_threshold=args.bloom_threshold,
                        bloom_knee=args.bloom_knee,
                        bloom_strength=args.bloom_strength)


def _sky(args):
    builtin_dark = args.scene in ("cornell", "triangle")
    return "black" if builtin_dark and not (args.obj or args.gltf) \
        else "gradient"


def _kernel_launches() -> dict:
    """Launches of each CUDA kernel wrapper so far in this process, by
    kernel name."""
    from wc_path_tracer_tpu_torch.kernels import launches
    return launches.named(launches.read_counts())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _report_scene(scene, seconds):
    """One stderr line: the scene's triangles and draws, how long it took
    to build, and which BVH builder built its meshes."""
    from wc_path_tracer_tpu_torch.scene import native
    draws = int(scene.mesh.draw_count)
    tris = int(scene.mesh.draw_index_count[:draws].sum()) // 3
    how = native.status() if draws else "none (no mesh)"
    print(f"scene: {tris} triangles, {draws} draw(s), built in "
          f"{seconds:.2f} s; bvh builder: {how}", file=sys.stderr)


def cmd_render(args, device):
    from wc_path_tracer_tpu_torch.render import dispatch, golden
    from wc_path_tracer_tpu_torch.render.renderer import Renderer
    from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
    from wc_path_tracer_tpu_torch.utils.metrics import MetricsLogger, mrays

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        sys.exit("error: render runs in one process; it was started as one "
                 "of several ranks (WORLD_SIZE > 1), whose outputs would "
                 "overwrite each other")
    t_scene = time.perf_counter()
    scene, cam = _build_scene(args, device)
    _report_scene(scene, time.perf_counter() - t_scene)
    cfg = _make_cfg(args, _sky(args))
    r = Renderer(scene, cam, cfg, renderer=args.renderer, device=device)
    if args.resume:
        from wc_path_tracer_tpu_torch.utils.checkpoint import load_renderer
        load_renderer(args.resume, r)
        print(f"resumed at frame {r.frame_count}", file=sys.stderr)
    cfg = r.cfg

    log = MetricsLogger(args.metrics)
    # the share of dispatched lane-segments that are alive (after misses and
    # RR), counted through the active backend
    segments = cfg.width * cfg.height * cfg.samples * (cfg.max_bounces + 1)
    alive_frac = golden.count_alive_segments(
        r.scene, camera_matrices(r.camera, cfg.width / cfg.height), cfg, 1,
        dispatch.get_intersect_fn(args.renderer, r.scene, cfg)) / segments

    t0 = time.perf_counter()
    for _ in range(args.frames):
        before = _kernel_launches()
        _sync(device)
        ft = time.perf_counter()
        r.step(1)
        _sync(device)
        dt = time.perf_counter() - ft
        dispatched = mrays(cfg.width, cfg.height, cfg.samples,
                           cfg.max_bounces, dt)
        after = _kernel_launches()
        log.log("frame", frame=r.frame_count, seconds=round(dt, 4),
                mrays_per_s=round(dispatched, 2),
                alive_fraction=round(alive_frac, 4),
                alive_mrays_per_s=round(dispatched * alive_frac, 2),
                kernel_launches={k: after[k] - before[k] for k in after})
    log.close()
    print(f"rendered {args.frames} frames in {time.perf_counter()-t0:.2f}s "
          f"on {device}", file=sys.stderr)

    if args.checkpoint:
        from wc_path_tracer_tpu_torch.utils.checkpoint import save_renderer
        save_renderer(args.checkpoint, r)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)
    r.save_png(args.out, tonemap=args.tonemap, gamma=args.gamma)
    print(f"wrote {args.out}", file=sys.stderr)

    if args.debug_bvh:
        # BVH wireframe overlay: the capability the reference wires up but
        # ships commented out (src/editor.jai:159-171)
        import numpy as np

        from wc_path_tracer_tpu_torch.io.image import write_png
        from wc_path_tracer_tpu_torch.render.debug import draw_aabb_overlay
        mats = camera_matrices(r.camera, cfg.width / cfg.height)
        over = draw_aabb_overlay(r.image, mats, r.scene.mesh.bvh_min,
                                 r.scene.mesh.bvh_max)
        write_png(args.debug_bvh,
                  (np.clip(over, 0.0, 1.0) * 255.0).astype(np.uint8))
        print(f"wrote BVH overlay {args.debug_bvh}", file=sys.stderr)
    return r


def _process_group(args):
    """The world group when this process was started as a rank (WORLD_SIZE
    > 1 in the environment, as torchrun sets it), else None."""
    from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    if args.backend is None:
        sys.exit("error: started as one of several ranks; pass --backend "
                 "nccl (one card per rank) or gloo")
    return pmesh.initialize_distributed(args.backend, "env://", world,
                                        int(os.environ["RANK"]))


def cmd_invert(args, device):
    import dataclasses

    import numpy as np

    from wc_path_tracer_tpu_torch.optim.inverse import (InverseRenderConfig,
                                                        run_inverse_rendering)
    from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
    from wc_path_tracer_tpu_torch.render import dispatch
    from wc_path_tracer_tpu_torch.scene.camera import camera_matrices
    from wc_path_tracer_tpu_torch.utils.metrics import MetricsLogger

    group = _process_group(args)
    lead = pmesh.rank(group) == 0
    scene, cam = _build_scene(args, device)
    cfg = _make_cfg(args, _sky(args))
    if args.target:
        target = torch.as_tensor(np.load(args.target), dtype=torch.float32,
                                 device=device)
    else:
        # self-calibration demo: target = the true scene; start perturbed
        with torch.no_grad():
            target = dispatch.get_render_frame(args.renderer, scene, cfg)(
                scene, camera_matrices(cam, cfg.width / cfg.height), cfg, 0)
        rng = np.random.default_rng(0)
        m = scene.materials
        noise = torch.as_tensor(rng.normal(0, 0.2, tuple(m.albedo.shape)),
                                dtype=torch.float32, device=device)
        scene = dataclasses.replace(scene, materials=dataclasses.replace(
            m, albedo=torch.clamp(m.albedo + noise, 0.0, 1.0),
            emission_strength=m.emission_strength * 0.3))

    log = MetricsLogger(args.metrics if lead else None, echo=lead)
    inv = InverseRenderConfig(trainable=tuple(args.trainable.split(",")),
                              learning_rate=args.lr, steps=args.steps,
                              log_every=args.log_every)
    # the Camera (not prebuilt matrices), so camera_* trainables work
    scene, cam, history = run_inverse_rendering(
        scene, cam, target, cfg, inv, renderer=args.renderer, group=group,
        log_fn=lambda rec: log.log("opt_step", **rec),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume)
    log.close()
    if lead:
        print(f"final loss {history[-1]['loss']:.6g}", file=sys.stderr)
    if args.out_dir and lead:
        from wc_path_tracer_tpu_torch.utils.checkpoint import save_pytree
        save_pytree(args.out_dir, {"scene": scene, "camera": cam})
        print(f"optimized scene -> {args.out_dir}", file=sys.stderr)
    if group is not None:
        dist.destroy_process_group()
    return history


def cmd_info(args, device):
    from wc_path_tracer_tpu_torch.parallel import mesh as pmesh
    from wc_path_tracer_tpu_torch.scene import native
    group = _process_group(args)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device: {device} ({name})")
    print(f"cuda devices: {torch.cuda.device_count()}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(f"rank: {pmesh.rank(group)}/{pmesh.world_size(group)}")
    print(f"bvh builder: {native.status()}")
    if group is not None:
        dist.destroy_process_group()


def _resolve(args):
    """The device the command runs on: ``--device``, or the CUDA card; under
    a multi-rank launch, ``cuda`` is the rank's own card."""
    from wc_path_tracer_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="wc_path_tracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="progressive render to PNG")
    _add_render_args(pr)
    pr.add_argument("--frames", type=int, default=8)
    pr.add_argument("--out", default="render.png")
    pr.add_argument("--tonemap", default=None)
    pr.add_argument("--gamma", type=float, default=None)
    pr.add_argument("--debug-bvh", metavar="PNG",
                    help="also write the frame with BVH node AABB wireframes "
                         "overlaid (the reference's disabled box renderer, "
                         "src/editor.jai:159-171)")
    pr.add_argument("--checkpoint", help="save renderer state to this dir")
    pr.add_argument("--resume", help="resume renderer state from this dir")
    pr.add_argument("--metrics", help="JSONL metrics path")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("invert", help="inverse rendering")
    _add_render_args(pi)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=5e-2)
    pi.add_argument("--trainable", default="albedo,emission_strength")
    pi.add_argument("--target", help=".npy target image (else self-demo)")
    pi.add_argument("--out-dir", help="save optimized scene tensors here")
    pi.add_argument("--metrics", help="JSONL metrics path")
    pi.add_argument("--log-every", type=int, default=10)
    pi.add_argument("--checkpoint-dir",
                    help="persist (params, opt_state, step) here")
    pi.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint period in steps (0 = final only)")
    pi.add_argument("--resume", action="store_true",
                    help="resume an interrupted run from --checkpoint-dir")
    pi.add_argument("--backend", choices=["nccl", "gloo"],
                    help="process-group backend when started as a rank")
    pi.set_defaults(fn=cmd_invert)

    pn = sub.add_parser("info", help="device and process-group info")
    pn.add_argument("--device", default=None)
    pn.add_argument("--backend", choices=["nccl", "gloo"])
    pn.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    try:
        device = _resolve(args)
    except RuntimeError as e:
        ap.error(str(e))
    return args.fn(args, device)


if __name__ == "__main__":
    main()

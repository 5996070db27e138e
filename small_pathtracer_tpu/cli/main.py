"""CLI driver: render / benchmark / fit (inverse rendering) subcommands."""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="cornell_box",
                   help="scene preset (cornell_box | cornell_spheres | "
                        "smallpt_original | cornell_twolights | "
                        "cornell_tilted_light | cornell_glossy | "
                        "cornell_alcove | cornell_alcove_baffled | "
                        "veach_mis | sphere_grid[_256|_1024])")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--estimator", default="nee",
                   help="uniform | uniform_corrected | cosine | nee | "
                        "mixture | nee_textbook (unbiased shadow-ray NEE) "
                        "| mis (balance-heuristic MIS over light + BSDF "
                        "sampling)")
    p.add_argument("--mixture-q", type=float, default=0.5)
    p.add_argument("--light-sample-mode", default="intended",
                   choices=["intended", "glibc_overflow"])
    p.add_argument("--light-select", default="power",
                   choices=["power", "uniform"],
                   help="multi-emitter light-list selection heuristic "
                        "(scenes with scene.lights, e.g. cornell_twolights)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--filter", default="box", choices=["box", "tent"],
                   dest="pixel_filter",
                   help="pixel reconstruction filter: box = the reference's "
                        "uniform jitter (C4); tent = original smallpt's "
                        "2-pixel triangle filter")
    p.add_argument("--aperture", type=float, default=0.0,
                   help="thin-lens radius in scene units (0 = the "
                        "reference's pinhole); depth of field focused at "
                        "--focus-dist")
    p.add_argument("--focus-dist", type=float, default=163.0,
                   help="focal-plane distance along the view axis "
                        "(default 163 = the reference's lookfrom->lookat "
                        "distance)")
    p.add_argument("--wavefront", default="regen", choices=["regen", "scan"])
    p.add_argument("--pallas", action="store_true", dest="use_pallas",
                   help="use the fused Pallas megakernel (all materials "
                   "incl. SPEC/REFR and all estimators; requires "
                   "rng mix/mix_packed). fit --pallas runs the adjoint "
                   "kernels: materials (albedo/emission) and, with "
                   "--train center,radius, sphere geometry over the "
                   "runtime sphere table — no recompile per step")
    p.add_argument("--rng", default="mix",
                   choices=["mix", "mix_packed", "threefry"],
                   dest="rng_backend")
    p.add_argument("--sphere-table", default="auto",
                   choices=["auto", "on", "off"],
                   help="megakernel scalable-scene mode: loop the spheres "
                        "through a runtime table instead of unrolling "
                        "them (O(1) compiled code size at any sphere "
                        "count; geometry edits never recompile). auto = "
                        "table at >= 48 spheres")
    p.add_argument("--sampler", default="random",
                   choices=["random", "sobol"],
                   help="sample sequences for the jitter/lens/light/scatter "
                        "dimensions: independent hash uniforms (the "
                        "reference's behavior) or per-pixel Owen-scrambled "
                        "(0,2)-sequences (lower MSE at equal spp; core/ld.py)")
    p.add_argument("--mesh", default="",
                   help="distributed mesh shape 'SPxDP' (e.g. 4x2); empty = single device")
    p.add_argument("--coordinator", default="",
                   help="multi-host: jax.distributed coordinator host:port")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=-1)
    p.add_argument("--checkpoint", default="",
                   help="render-state checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save render state every N spp (0 = only at end)")
    p.add_argument("--preview", default="",
                   help="progressive preview: write the tonemapped running "
                        "mean here (atomically, PPM/PNG by extension) after "
                        "every --preview-every spp chunk — the intermediate "
                        "dumps the reference lacks (SURVEY.md section 5)")
    p.add_argument("--preview-every", type=int, default=0,
                   help="preview/chunk interval in spp (default: "
                        "--checkpoint-every, else spp/8)")
    p.add_argument("--guided", action="store_true",
                   help="voxel path guiding (experiment/path_guiding.py): "
                        "train a lobe table with a short pre-pass, then "
                        "importance-sample the guided mixture (jnp "
                        "estimator); estimator must be cosine or "
                        "nee_textbook")
    p.add_argument("--guide-beta", type=float, default=0.6,
                   help="guided-mixture lobe probability in guided voxels")
    p.add_argument("--guide-k", type=float, default=8.0,
                   help="power-cosine lobe sharpness")
    p.add_argument("--guide-train-spp", type=int, default=16,
                   help="spp of the guide-training pre-pass (at 1/8 res)")
    p.add_argument("--guide-bounces", type=int, default=8,
                   help="bounce depth for guide training and guided render")
    p.add_argument("--aov", default="",
                   help="also render first-hit feature buffers "
                        "(utils/aov.py) and write PREFIX.{albedo,normal,"
                        "depth,coverage}.ppm plus PREFIX.npz with the raw "
                        "float32 arrays")
    p.add_argument("--aov-spp", type=int, default=0,
                   help="primary samples for the AOV pass (0 = auto: "
                        "min(spp, 64) — feature buffers converge far "
                        "faster than radiance)")
    p.add_argument("--denoise", type=int, nargs="?", const=5, default=0,
                   metavar="N",
                   help="edge-aware a-trous denoise (utils/denoise.py) "
                        "with N passes (bare flag = 5; support is "
                        "4*2^N+1 px) guided by an AOV pre-pass; filters "
                        "the LINEAR image before tonemapping. Composes "
                        "with every render path (pure post-process)")
    p.add_argument("--denoise-sigma-l", type=float, default=0.5,
                   help="denoiser luminance edge stop (bigger = smoother)")


def _fit_result(loss, ran_steps: bool, steps: int) -> dict:
    """Strict-JSON fit summary distinguishing the two non-numeric cases:
    a checkpoint already past --steps (no work left) vs a run whose last
    step diverged to NaN."""
    out = {"steps": steps}
    if not ran_steps:
        out["final_loss"] = None
        out["already_complete"] = True
    elif float(loss) != float(loss):
        out["final_loss"] = None
        out["diverged"] = True
    else:
        out["final_loss"] = float(loss)
    return out


def _mesh_from_arg(args):
    """Parse --mesh 'SPxDP' into a device mesh (None when unset)."""
    if not getattr(args, "mesh", ""):
        return None
    import jax

    from ..parallel.mesh import make_mesh

    sp, dp = (int(x) for x in args.mesh.lower().split("x"))
    return make_mesh(jax.devices()[: sp * dp], mesh_shape=(sp, dp))


def _build(args):
    if getattr(args, "coordinator", ""):
        from ..parallel.launcher import init_distributed

        init_distributed(
            args.coordinator,
            args.num_processes or None,
            args.process_id if args.process_id >= 0 else None,
        )

    from .. import RenderConfig, get_scene, make_camera

    cfg = RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        estimator=args.estimator, mixture_q=args.mixture_q,
        light_sample_mode=args.light_sample_mode, seed=args.seed,
        light_select=args.light_select,
        wavefront=args.wavefront, rng_backend=args.rng_backend,
        sampler=getattr(args, "sampler", "random"),
        use_pallas=getattr(args, "use_pallas", False),
        pixel_filter=getattr(args, "pixel_filter", "box"),
        aperture=getattr(args, "aperture", 0.0),
        focus_dist=getattr(args, "focus_dist", 163.0),
        sphere_table=getattr(args, "sphere_table", "auto"),
    )
    scene = get_scene(args.scene)
    cam = make_camera(aspect=args.width / args.height)
    return scene, cam, cfg


def _render_guided_cli(args, scene, cam, cfg):
    """render --guided: short training pre-pass -> lobe table -> guided
    render on the jnp estimator. The pre-pass trains at ~1/8 resolution —
    the 10-unit voxel grid (experiment/path_guiding.py, smallpt.cpp:386-388)
    needs coverage, not pixels. Returns (linear mean image, total traces
    proxy)."""
    import jax.numpy as jnp

    from .. import RenderConfig
    from ..experiment.path_guiding import (
        guide_lobes,
        render_guided,
        train_guide,
    )

    tcfg = RenderConfig(
        width=max(args.width // 8, 16), height=max(args.height // 8, 16),
        spp=args.guide_train_spp, seed=args.seed + 1,
        rng_backend=cfg.rng_backend,
    )
    guide = guide_lobes(
        train_guide(scene, cam, tcfg, args.guide_bounces,
                    jnp.uint32(tcfg.seed))
    )
    n_guided = int(jnp.asarray(guide[1]).sum())
    print(f"guide table trained: {n_guided} guided voxels", file=sys.stderr)
    est = "cosine" if cfg.estimator == "cosine" else "nee"
    img = render_guided(
        scene, cam, cfg, jnp.uint32(cfg.seed), guide, args.guide_bounces,
        args.guide_beta, args.guide_k, estimator=est,
    )
    # The jnp estimator does not count traces; report ray-path volume.
    return img, float(cfg.width * cfg.height * cfg.spp * args.guide_bounces)


def _check_guided_args(ap, args) -> None:
    """--guided runs on the jnp estimator only; refuse what it cannot do."""
    if not getattr(args, "guided", False):
        return
    if getattr(args, "use_pallas", False):
        ap.error("--guided runs on the jnp estimator; drop --pallas")
    if args.checkpoint or args.mesh or args.preview:
        ap.error("--guided does not compose with --checkpoint/--mesh/"
                 "--preview")
    if args.estimator not in ("cosine", "nee_textbook"):
        ap.error("--guided requires --estimator cosine or nee_textbook "
                 "(C13-continuation estimators replace the bounce with "
                 "the light sample, leaving nothing to guide)")


def _write_aovs(prefix: str, aovs) -> None:
    """Dump feature buffers: eyeball PPMs + one npz of the raw floats.

    albedo is tonemapped like a render; normal is mapped [-1,1] -> [0,1]
    linearly (no gamma); depth is normalized to its max; coverage is a
    direct [0,1] grayscale.
    """
    import numpy as np

    from ..core import film

    def u8(x):
        return np.asarray(
            np.clip(np.asarray(x, np.float32), 0.0, 1.0) * 255.0 + 0.5
        ).astype(np.uint8)

    def gray3(x):
        return np.repeat(np.asarray(x)[..., None], 3, axis=-1)

    alb, nrm = aovs["albedo"], aovs["normal"]
    dep, cov = aovs["depth"], aovs["coverage"]
    film.write_ppm(prefix + ".albedo.ppm", np.asarray(film.tonemap_u8(alb)))
    film.write_ppm(prefix + ".normal.ppm", u8((np.asarray(nrm) + 1.0) * 0.5))
    dmax = float(np.asarray(dep).max())
    film.write_ppm(prefix + ".depth.ppm",
                   gray3(u8(np.asarray(dep) / (dmax if dmax > 0 else 1.0))))
    film.write_ppm(prefix + ".coverage.ppm", gray3(u8(cov)))
    np.savez(prefix + ".npz",
             **{k: np.asarray(v, np.float32) for k, v in aovs.items()})


def cmd_render(args) -> int:
    import numpy as np

    from ..core import film

    scene, cam, cfg = _build(args)
    t0 = time.perf_counter()
    if getattr(args, "adaptive_tol", 0.0) > 0.0:
        if args.mesh or args.checkpoint or args.preview or getattr(
                args, "guided", False):
            raise SystemExit(
                "--adaptive-tol composes with --pallas only (not --mesh/"
                "--checkpoint/--preview/--guided)"
            )
        from ..utils.adaptive import adaptive_render

        res = adaptive_render(
            scene, cam, cfg, tol=args.adaptive_tol,
            wave=args.adaptive_wave, log=sys.stderr,
        )
        img, traces = res.image, res.traces[0] + res.traces[1]
        print(
            f"[adaptive] {res.waves} waves, {res.total_samples} samples "
            f"({100.0 * res.total_samples / res.uniform_samples:.0f}% of "
            f"uniform {cfg.spp} spp), spp range "
            f"{int(res.spp_map.min())}-{int(res.spp_map.max())}",
            file=sys.stderr,
        )
        if args.adaptive_map:
            from ..core import film
            import numpy as np

            m = res.spp_map.astype(np.float32) / float(res.spp_map.max())
            film.write_ppm(
                args.adaptive_map,
                np.asarray(film.tonemap_u8(
                    np.repeat(m[..., None], 3, axis=-1)
                )),
            )
    elif getattr(args, "guided", False):
        img, traces = _render_guided_cli(args, scene, cam, cfg)
    elif args.checkpoint or args.preview:
        from ..utils.checkpoint import render_with_checkpoints

        mesh = _mesh_from_arg(args)
        every = args.checkpoint_every
        if args.preview:
            every = (args.preview_every or args.checkpoint_every
                     or max(1, cfg.spp // 8))
        img, traces = render_with_checkpoints(
            scene, cam, cfg, args.checkpoint, every,
            mesh=mesh, preview_path=args.preview,
        )
    elif args.mesh:
        mesh = _mesh_from_arg(args)
        if cfg.use_pallas:
            from ..ops.megakernel import render_pallas_sharded, trace_totals

            img, traces = render_pallas_sharded(
                scene, cam, cfg, mesh, cfg.seed
            )
            img = film.finalize(
                img.reshape(cfg.height, cfg.width, 3) / cfg.spp
            )
            traces = float(trace_totals(traces).sum())
        else:
            from ..parallel.sharded import render_sharded

            img, traces = render_sharded(scene, cam, cfg, mesh)
    else:
        from ..integrator.wavefront import render

        img, traces = render(scene, cam, cfg)
    aov_prefix = getattr(args, "aov", "")
    n_denoise = getattr(args, "denoise", 0)
    if aov_prefix or n_denoise:
        # First-hit feature pass (cheap: one bounce-free trace per sample,
        # unsharded — at AOV spp it is a rounding error next to the render).
        from ..utils.aov import render_aovs

        aovs = render_aovs(
            scene, cam, cfg, spp=args.aov_spp if args.aov_spp > 0 else None
        )
        if n_denoise:
            from ..utils.denoise import denoise

            import jax.numpy as jnp

            img = film.finalize(denoise(
                jnp.asarray(img, jnp.float32), aovs,
                iterations=n_denoise, sigma_l=args.denoise_sigma_l,
            ))
        if aov_prefix:
            _write_aovs(aov_prefix, aovs)
    dt = time.perf_counter() - t0
    u8 = np.asarray(film.tonemap_u8(img))
    out = args.output
    if out.endswith(".ppm"):
        film.write_ppm(out, u8)
    else:
        from ..core.imageio import write_image

        write_image(out, u8)
    print(
        f"wrote {out}  {cfg.width}x{cfg.height}x{cfg.spp}spp "
        f"{traces / dt / 1e6:.1f} Mrays/s  {dt:.2f}s",
        file=sys.stderr,
    )
    return 0


def cmd_bench(args) -> int:
    import jax

    scene, cam, cfg = _build(args)
    if args.mesh:
        from ..parallel.sharded import render_sharded

        mesh = _mesh_from_arg(args)

        def run():
            return render_sharded(scene, cam, cfg, mesh)
    else:
        from ..integrator.wavefront import render

        def run():
            return render(scene, cam, cfg)

    jax.block_until_ready(run())  # warmup+compile
    t0 = time.perf_counter()
    img, traces = jax.block_until_ready(run())
    dt = time.perf_counter() - t0
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": (
            f"Mrays/s ({args.scene} {cfg.width}x{cfg.height}x{cfg.spp}spp "
            f"{cfg.estimator}, {dev.platform} {dev.device_kind} "
            f"x{len(jax.devices())})"
        ),
        "value": round(traces / dt / 1e6, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(traces / dt / 1e6 / 2.5, 2),
    }))
    return 0


def cmd_viz(args) -> int:
    """State-space visualization (SURVEY section 3.5; smallpt.cpp:424-442)."""
    import numpy as np

    from ..core import film
    from ..experiment.state_space import create_state_space, render_state_viz

    scene, cam, cfg = _build(args)
    img, n_red = render_state_viz(scene, cam, cfg.width, cfg.height)
    n_states = create_state_space(scene)
    u8 = np.asarray(film.tonemap_u8(img))
    film.write_ppm(args.output, u8)
    print(
        f"wrote {args.output}  NUMBER OF STATES: {n_states}  "
        f"COUNTER RED: {n_red}",
        file=sys.stderr,
    )
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering: recover scene parameters from a target image."""
    import numpy as np

    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")

    import jax.numpy as jnp

    from ..core import film
    from ..grad.adjoint import make_sharded_train_step, render_linear
    from ..parallel.mesh import make_mesh

    scene, cam, cfg = _build(args)
    if (cfg.aperture > 0.0 or cfg.pixel_filter != "box") and (
        args.camera_edge or args.edge_sphere >= 0 or args.soft_tau > 0
    ):
        # The boundary-gradient estimators (grad/edge.py, grad/camera_edge
        # .py, grad/soft.py) derive silhouette velocities from PINHOLE ray
        # geometry; a lens or reshaped filter would silently bias them.
        raise SystemExit(
            "--camera-edge/--edge-sphere/--soft-tau assume the reference's "
            "pinhole box-filter camera; drop --aperture/--filter tent for "
            "boundary-gradient fits"
        )
    if args.camera_edge:
        # Camera-pose fitting on the HARD render: pathwise (interior) +
        # exact scene-edge boundary gradients (grad/camera_edge.py).
        # Normalized-step descent — the gradient direction is reliable
        # but its scale spans decades across poses (edge term ~ jump *
        # screen speed), so step length = min(lr, 3e5*|d|) decaying 0.9x.
        from ..grad.camera_edge import (
            camera_edge_grad,
            camera_rotation_edge_grad,
            rotate_camera,
        )

        if args.optimizer != "sgd":
            raise SystemExit("--camera-edge supports --optimizer sgd")
        fit_rot = args.camera_rotation
        w_rot = jnp.zeros(3, jnp.float32)
        if args.target:
            target = jnp.asarray(
                film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
            )
            t = jnp.zeros(3, jnp.float32)
        else:
            # Self-test: render the target at the configured camera, then
            # displace (kept inside the box: -z is INTO the scene) and
            # recover the pose.
            target = render_linear(scene, cam, cfg,
                                   jnp.uint32(cfg.seed + 1), args.bounces)
            t = jnp.asarray([3.0, -2.0, -4.0], jnp.float32)
            if fit_rot:
                w_rot = jnp.asarray([0.06, -0.04, 0.03], jnp.float32)

        def shifted(base, tv):
            return base._replace(
                origin=jnp.asarray(base.origin, jnp.float32) + tv,
                lower_left=jnp.asarray(base.lower_left, jnp.float32) + tv,
            )

        import jax as _jax

        # The camera state itself is the optimization variable (rotations
        # compose, so a global axis-angle coordinate would drift); t and
        # w_rot accumulate the per-step increments for reporting.
        cam_cur = shifted(rotate_camera(cam, w_rot) if fit_rot else cam, t)
        zero3 = jnp.zeros(3, jnp.float32)
        loss = float("nan")
        step_len = args.lr
        # 1 rad of rotation sweeps the image like ~(camera-to-scene
        # distance) units of lateral translation, so the rotation step
        # length lives ~300x below the translation one by default.
        step_len_rot = (
            args.lr_rot if args.lr_rot is not None else args.lr / 300.0
        )
        for i in range(args.steps):
            cam_i = cam_cur

            def loss_fn(dt, dw):
                c = rotate_camera(cam_i, dw) if fit_rot else cam_i
                img = render_linear(scene, shifted(c, dt), cfg,
                                    jnp.uint32(cfg.seed + 2 * i),
                                    args.bounces)
                return jnp.mean((img - target) ** 2), img

            (loss, img), pw = _jax.value_and_grad(
                loss_fn, has_aux=True, argnums=(0, 1) if fit_rot else 0
            )(zero3, zero3)
            g_img = 2.0 * (img - target) / jnp.float32(img.size)
            pw_t = pw[0] if fit_rot else pw
            d_edge = camera_edge_grad(
                scene, cam_i, cfg, g_img, seed=cfg.seed + 1000 + i,
                n_u=64, n_phi=args.edge_phi, n_sub=2,
                n_bounces=args.bounces, delta_px=0.25,
            )
            d = np.asarray(pw_t) + np.asarray(d_edge)
            nd = float(np.linalg.norm(d))
            step = -d / max(nd, 1e-12) * min(step_len, 3e5 * nd)
            t = t + jnp.asarray(step, jnp.float32)
            cam_cur = shifted(cam_cur, jnp.asarray(step, jnp.float32))
            if fit_rot:
                d_rot = np.asarray(pw[1]) + np.asarray(
                    camera_rotation_edge_grad(
                        scene, cam_i, cfg, g_img,
                        seed=cfg.seed + 5000 + i, n_u=64,
                        n_phi=args.edge_phi, n_sub=2,
                        n_bounces=args.bounces, delta_px=0.25,
                    )
                )
                ndr = float(np.linalg.norm(d_rot))
                step_r = -d_rot / max(ndr, 1e-12) * min(
                    step_len_rot, 3e5 * ndr
                )
                w_rot = w_rot + jnp.asarray(step_r, jnp.float32)
                cam_cur = rotate_camera(
                    cam_cur, jnp.asarray(step_r, jnp.float32)
                )
                step_len_rot *= 0.9
            step_len *= 0.9
            msg = (
                f"step {i}: loss {float(loss):.6f} "
                f"t {[round(float(v), 3) for v in t]}"
            )
            if fit_rot:
                msg += f" w {[round(float(v), 4) for v in w_rot]}"
            print(msg, file=sys.stderr)
        out = _fit_result(loss, ran_steps=args.steps > 0, steps=args.steps)
        out["camera_translation"] = [float(v) for v in t]
        out["origin"] = [float(v) for v in cam_cur.origin]
        if fit_rot:
            # Sum of per-step axis-angle increments — exact pose is
            # cam_cur; this is the (small-angle) rotation summary.
            out["camera_rotation"] = [float(v) for v in w_rot]
        print(json.dumps(out))
        return 0

    if args.edge_sphere >= 0:
        # Edge-sampled geometry fitting: pathwise + silhouette +
        # cast-shadow boundary gradients (grad/edge.py) on one sphere's
        # center/radius. Unlike --soft-tau this differentiates the HARD
        # render — no blur, exact boundary terms.
        from ..grad.edge import geometry_loss_and_grad

        fields = set(args.train.split(","))
        bad = fields - {"center", "radius"}
        if bad:
            raise SystemExit(
                f"--edge-sphere trains center,radius only (got {sorted(bad)})"
            )
        if args.optimizer != "sgd":
            raise SystemExit("--edge-sphere supports --optimizer sgd")
        si = args.edge_sphere
        if scene.spheres.center.shape[0] <= si:
            raise SystemExit(
                f"scene has {scene.spheres.center.shape[0]} spheres; "
                f"--edge-sphere {si} out of range"
            )
        if args.target:
            target = jnp.asarray(
                film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
            )
        else:
            # Self-test: render the scene as the target, then displace the
            # sphere and recover its pose.
            from ..grad.adjoint import render_linear as _rl

            target = _rl(scene, cam, cfg, jnp.uint32(cfg.seed + 1),
                         args.bounces)
            scene = scene._replace(spheres=scene.spheres._replace(
                center=scene.spheres.center.at[si].add(
                    jnp.asarray([4.0, 0.0, -3.0])),
                radius=scene.spheres.radius.at[si].multiply(1.1),
            ))
        s = scene
        loss = float("nan")
        for i in range(args.steps):
            loss, (d_c, d_r) = geometry_loss_and_grad(
                s, cam, cfg, cfg.seed + 2 * i, target, si,
                n_bounces=args.bounces, n_phi=args.edge_phi,
            )
            upd = {}
            if "center" in fields:
                upd["center"] = s.spheres.center.at[si].add(-args.lr * d_c)
            if "radius" in fields:
                r_new = float(s.spheres.radius[si]) - args.lr * float(d_r)
                upd["radius"] = s.spheres.radius.at[si].set(
                    max(r_new, 1e-3))
            s = s._replace(spheres=s.spheres._replace(**upd))
            c_now = [round(float(v), 3) for v in s.spheres.center[si]]
            print(
                f"step {i}: loss {float(loss):.6f} center {c_now} "
                f"radius {float(s.spheres.radius[si]):.3f}",
                file=sys.stderr,
            )
        out = _fit_result(loss, ran_steps=args.steps > 0, steps=args.steps)
        out["center"] = [float(v) for v in s.spheres.center[si]]
        out["radius"] = float(s.spheres.radius[si])
        print(json.dumps(out))
        return 0

    if args.fd_sphere >= 0:
        # Geometry fitting by common-random-number central differences
        # through the TABLE megakernel (grad/fd.py) — every probe is a
        # kernel re-render, no recompile, any sphere count.
        from ..grad.fd import FIELDS, _render_mean, _table_cfg, fit_fd

        fields = tuple(args.train.split(","))
        bad = [f for f in fields if f not in FIELDS]
        if bad or args.optimizer != "sgd":
            raise SystemExit(
                f"fit --fd-sphere trains {sorted(FIELDS)} with "
                f"--optimizer sgd (got {bad or args.optimizer})"
            )
        si = args.fd_sphere
        if scene.spheres.center.shape[0] <= si:
            raise SystemExit(
                f"scene has {scene.spheres.center.shape[0]} spheres; "
                f"--fd-sphere {si} out of range"
            )
        cfg_t = _table_cfg(cfg)
        if args.target:
            target = jnp.asarray(
                film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
            )
        else:
            # Self-test: independent-seed target, then displace and recover.
            target = _render_mean(scene, cam, cfg_t, cfg.seed + 1)
            scene = scene._replace(spheres=scene.spheres._replace(
                center=scene.spheres.center.at[si].add(
                    jnp.asarray([4.0, 0.0, -3.0])),
                radius=scene.spheres.radius.at[si].multiply(1.1),
            ))
        s, losses = fit_fd(
            scene, cam, cfg_t, target, si, fields, steps=args.steps,
            lr=args.lr, delta=args.fd_delta, seed=cfg.seed,
            log=sys.stderr,
        )
        out = _fit_result(losses[-1] if losses else float("nan"),
                          ran_steps=bool(losses), steps=args.steps)
        out["center"] = [float(v) for v in s.spheres.center[si]]
        out["radius"] = float(s.spheres.radius[si])
        print(json.dumps(out))
        return 0

    if args.soft_tau > 0:
        # Soft-visibility geometry fitting (silhouette + soft-shadow
        # gradients, grad/soft.py) on selected fields; SGD or any optax
        # optimizer. (Checked FIRST — this path needs no path-traced
        # target or mesh.)
        import jax.tree_util as jtu

        from ..grad.soft import soft_loss_and_grad, soft_render

        fields = set(args.train.split(","))
        if args.target:
            target = jnp.asarray(
                film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
            )
        else:
            target = soft_render(scene, cam, cfg, jnp.uint32(cfg.seed + 1),
                                 args.soft_tau)

        def trainable(path, p):
            name = next((k.name for k in reversed(path)
                         if isinstance(k, jtu.GetAttrKey)), "")
            return (
                hasattr(p, "dtype") and p.dtype.kind == "f"
                and name in fields
            )

        # Training-state checkpoint (same machinery as the adjoint path):
        # counter-RNG steps make a resume bit-identical to the
        # uninterrupted run.
        ck_path = args.checkpoint or None
        ck_every = args.checkpoint_every
        if ck_path:
            from ..utils.train_checkpoint import (
                load_train_state,
                save_train_state,
                train_tag,
            )

            tag = train_tag(
                cfg,
                f"fit-soft|{args.optimizer}|{args.lr}|{args.train}"
                f"|{args.soft_tau}",
                scene=scene, cam=cam, target=target,
            )

        def maybe_save(i, params, opt_state=None):
            if ck_path and (
                i == args.steps - 1
                or (ck_every and (i + 1) % ck_every == 0)
            ):
                save_train_state(ck_path, i + 1, params, opt_state, tag=tag)

        loss = float("nan")
        start = 0
        if args.optimizer == "sgd":
            def upd(path, p, g):
                return p - args.lr * g if trainable(path, p) else p

            s = scene
            if ck_path:
                st = load_train_state(ck_path, s, tag=tag)
                if st is not None:
                    start, s, _ = st
            for i in range(start, args.steps):
                loss, g = soft_loss_and_grad(
                    s, cam, cfg, jnp.uint32(cfg.seed), target, args.soft_tau
                )
                s = jtu.tree_map_with_path(upd, s, g)
                print(f"step {i}: loss {float(loss):.6f}", file=sys.stderr)
                maybe_save(i, s)
        else:
            import optax

            base = {
                "adam": optax.adam(args.lr),
                "rmsprop": optax.rmsprop(args.lr),
            }[args.optimizer]
            tx = optax.multi_transform(
                {"train": base, "freeze": optax.set_to_zero()},
                param_labels=lambda sc: jtu.tree_map_with_path(
                    lambda path, p: "train" if trainable(path, p)
                    else "freeze", sc,
                ),
            )
            s = scene
            state = tx.init(s)
            if ck_path:
                st = load_train_state(ck_path, s, state, tag=tag)
                if st is not None:
                    start, s, state = st
            for i in range(start, args.steps):
                loss, g = soft_loss_and_grad(
                    s, cam, cfg, jnp.uint32(cfg.seed), target, args.soft_tau
                )
                g = jtu.tree_map(
                    lambda p, gg: gg if jnp.issubdtype(
                        jnp.asarray(p).dtype, jnp.floating
                    ) else jnp.zeros_like(p), s, g,
                )
                upds, state = tx.update(g, state, s)
                new_s = optax.apply_updates(s, upds)
                s = jtu.tree_map(
                    lambda p, q: q if jnp.issubdtype(
                        jnp.asarray(p).dtype, jnp.floating
                    ) else p, s, new_s,
                )
                print(f"step {i}: loss {float(loss):.6f}", file=sys.stderr)
                maybe_save(i, s, state)
        print(json.dumps(_fit_result(loss, ran_steps=start < args.steps,
                                     steps=args.steps)))
        return 0

    if cfg.use_pallas and (
        {"center", "radius"} & set(args.train.split(","))
    ):
        # Kernel-path GEOMETRY fitting: the geometry-adjoint megakernel
        # (ops/megakernel_geom.py) — pathwise interior cotangents for
        # every table sphere's center/radius (+ materials) in one kernel
        # launch per step (vs 2P+1 renders for fit --fd-sphere), for
        # tables up to GEOM_MAX_SPHERES spheres. --mesh SPxDP shards the
        # step over a device mesh (geom_train_step_sharded), same
        # trust-region trajectory.
        import dataclasses as _dc

        from ..ops.megakernel_geom import (
            GEOM_MAX_SPHERES,
            fit_pallas_geom,
            geom_run,
        )

        fields = tuple(args.train.split(","))
        bad = [f for f in fields
               if f not in ("center", "radius", "albedo", "emission")]
        if bad or args.optimizer != "sgd":
            raise SystemExit(
                "fit --pallas --train center,... supports --optimizer sgd "
                "on center/radius/albedo/emission "
                f"(got optimizer={args.optimizer}, fields={fields})"
            )
        si = args.fd_sphere if args.fd_sphere >= 0 else None
        n_sph = int(scene.spheres.center.shape[0])
        if n_sph == 0:
            raise SystemExit("scene has no spheres to fit")
        if n_sph > GEOM_MAX_SPHERES:
            raise SystemExit(
                f"fit --pallas geometry takes at most {GEOM_MAX_SPHERES} "
                f"spheres (scene has {n_sph}); drop --pallas or use "
                "--fd-sphere"
            )
        if si is not None and si >= n_sph:
            raise SystemExit(f"--fd-sphere {si} out of range ({n_sph})")
        cfg_g = _dc.replace(cfg, sphere_table="on")
        if args.target:
            target = jnp.asarray(
                film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
            )
        else:
            # Self-test: independent-seed target, then displace + recover
            # (same protocol as fit --fd-sphere for comparability).
            s0 = si if si is not None else 0
            img_sum, _, _, _ = geom_run(scene, cam, cfg_g, cfg.seed + 1)
            target = img_sum / cfg.spp
            scene = scene._replace(spheres=scene.spheres._replace(
                center=scene.spheres.center.at[s0].add(
                    jnp.asarray([4.0, 0.0, -3.0])),
                radius=scene.spheres.radius.at[s0].multiply(1.1),
            ))
        s, losses = fit_pallas_geom(
            scene, cam, cfg_g, target, sphere_idx=si, fields=fields,
            steps=args.steps, lr=args.lr, seed=cfg.seed, log=sys.stderr,
            mesh=_mesh_from_arg(args),
        )
        out = _fit_result(losses[-1] if losses else float("nan"),
                          ran_steps=bool(losses), steps=args.steps)
        ri = si if si is not None else 0
        out["center"] = [float(v) for v in s.spheres.center[ri]]
        out["radius"] = float(s.spheres.radius[ri])
        print(json.dumps(out))
        return 0

    if cfg.use_pallas:
        # Kernel-path material fitting: forward + adjoint megakernels with
        # runtime material tables (ops/megakernel_grad.py) — one compile,
        # SGD on albedo/emission only.
        from ..ops.megakernel import render_pallas
        from ..ops.megakernel_grad import fit_pallas

        fields = tuple(args.train.split(","))
        bad = [f for f in fields if f not in ("albedo", "emission")]
        if bad or args.optimizer != "sgd":
            raise SystemExit(
                "fit --pallas supports --optimizer sgd on albedo/emission "
                f"only (got optimizer={args.optimizer}, fields={fields}); "
                "drop --pallas for other parameters/optimizers"
            )
        if args.target:
            target = jnp.asarray(
                film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
            )
        else:
            bright = scene._replace(
                rects=scene.rects._replace(
                    emission=scene.rects.emission * 1.5
                )
            )
            img_sum, _ = render_pallas(bright, cam, cfg, cfg.seed + 1)
            target = img_sum / cfg.spp
        _, losses = fit_pallas(
            scene, cam, cfg, target, steps=args.steps, lr=args.lr,
            train_fields=fields, seed=cfg.seed, log=sys.stderr,
            checkpoint=args.checkpoint or None,
            checkpoint_every=args.checkpoint_every,
        )
        print(json.dumps(_fit_result(
            losses[-1] if losses else float("nan"),
            ran_steps=bool(losses), steps=args.steps,
        )))
        return 0

    if args.target:
        target = jnp.asarray(
            film.srgb_from_u8(film.read_ppm(args.target)), jnp.float32
        )
    else:
        # Self-test mode: perturb emission, recover it.
        bright = scene._replace(
            rects=scene.rects._replace(emission=scene.rects.emission * 1.5)
        )
        target = render_linear(bright, cam, cfg, jnp.uint32(cfg.seed + 1),
                               args.bounces)
    import jax

    mesh = _mesh_from_arg(args) or make_mesh(jax.devices()[:1],
                                             mesh_shape=(1, 1))
    # Optional training-state checkpoint (utils/train_checkpoint): resumed
    # if present, saved every --checkpoint-every steps (0 = at end only).
    ck_path = args.checkpoint or None
    ck_every = args.checkpoint_every
    if ck_path:
        from ..utils.train_checkpoint import (
            load_train_state,
            save_train_state,
            train_tag,
        )

        tag = train_tag(
            cfg,
            f"fit|{args.optimizer}|{args.lr}|{args.train}|{args.bounces}",
            scene=scene, cam=cam, target=target,
        )

    def maybe_save(i, params, opt_state=None):
        if ck_path and (
            i == args.steps - 1 or (ck_every and (i + 1) % ck_every == 0)
        ):
            save_train_state(ck_path, i + 1, params, opt_state, tag=tag)

    loss = float("nan")
    if args.optimizer == "sgd":
        step = make_sharded_train_step(
            cfg, mesh, target, n_bounces=args.bounces, lr=args.lr,
            train_fields=tuple(args.train.split(",")),
        )
        s, c = scene, cam
        start = 0
        if ck_path:
            st = load_train_state(ck_path, s, tag=tag)
            if st is not None:
                start, s, _ = st
        for i in range(start, args.steps):
            loss, s, c = step(s, c, jnp.uint32(cfg.seed))
            print(f"step {i}: loss {float(loss):.6f}", file=sys.stderr)
            maybe_save(i, s)
    else:
        from ..grad.adjoint import make_sharded_train_step_with_state

        init, step = make_sharded_train_step_with_state(
            cfg, mesh, target, n_bounces=args.bounces, lr=args.lr,
            train_fields=tuple(args.train.split(",")),
            optimizer=args.optimizer,
        )
        opt_state = init(scene)
        s = scene
        start = 0
        if ck_path:
            st = load_train_state(ck_path, s, opt_state, tag=tag)
            if st is not None:
                start, s, opt_state = st
        for i in range(start, args.steps):
            loss, s, opt_state = step(s, cam, jnp.uint32(cfg.seed), opt_state)
            print(f"step {i}: loss {float(loss):.6f}", file=sys.stderr)
            maybe_save(i, s, opt_state)
    print(json.dumps(_fit_result(loss, ran_steps=start < args.steps,
                                 steps=args.steps)))
    return 0


def cmd_serve(args) -> int:
    from .server import serve

    serve(args.host, args.port)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="small_pathtracer_tpu",
        description="Differentiable path tracer (JAX, Pallas on the GPU)",
    )
    ap.add_argument(
        "--platform", default="auto", choices=["auto", "cpu", "gpu"],
        help="force the JAX backend before any compute; 'auto' keeps "
        "JAX's default (the GPU when one is present).",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_render = sub.add_parser("render", help="render an image")
    _add_render_args(p_render)
    p_render.add_argument("-o", "--output", default="image.ppm")
    p_render.add_argument(
        "--adaptive-tol", type=float, default=0.0,
        help="adaptive sampling: stop a pixel when the standard error of "
             "its mean falls below TOL * (luma + 0.02); --spp becomes the "
             "per-pixel cap (utils/adaptive.py). 0 = uniform sampling")
    p_render.add_argument(
        "--adaptive-wave", type=int, default=0,
        help="samples per adaptive wave (0 = auto: spp/8, at least 8)")
    p_render.add_argument(
        "--adaptive-map", default="",
        help="also write the per-pixel spp heatmap to this PPM path")
    p_render.set_defaults(fn=cmd_render)

    p_bench = sub.add_parser("bench", help="measure Mrays/s")
    _add_render_args(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    p_viz = sub.add_parser(
        "viz", help="RL state-space false-color map (the reference's "
        "HEAD-mode show_*.ppm renders)"
    )
    _add_render_args(p_viz)
    p_viz.add_argument("-o", "--output", default="state_viz.ppm")
    p_viz.set_defaults(fn=cmd_viz)

    p_fit = sub.add_parser("fit", help="inverse rendering (gradient descent)")
    _add_render_args(p_fit)
    p_fit.add_argument("--target", default="", help="target PPM image")
    p_fit.add_argument("--steps", type=int, default=20)
    p_fit.add_argument("--lr", type=float, default=1.0)
    p_fit.add_argument("--bounces", type=int, default=16)
    p_fit.add_argument("--train", default="emission,albedo",
                       help="comma-separated scene fields to optimize")
    p_fit.add_argument("--optimizer", default="sgd",
                       choices=["sgd", "adam", "rmsprop"])
    p_fit.add_argument("--edge-sphere", type=int, default=-1,
                       help="fit sphere IDX's center/radius with exact "
                            "edge-sampled boundary gradients (grad/edge.py)")
    p_fit.add_argument("--fd-sphere", type=int, default=-1,
                       help="fit sphere IDX (center/radius/albedo/emission "
                            "via --train) with common-random-number "
                            "central differences through the TABLE "
                            "megakernel (grad/fd.py) — kernel renders, no "
                            "recompile per step, any sphere count; "
                            "normalized-step descent: --lr is the INITIAL "
                            "step length in scene units")
    p_fit.add_argument("--fd-delta", type=float, default=0.5,
                       help="FD step in scene units for --fd-sphere")
    p_fit.add_argument("--camera-edge", action="store_true",
                       help="fit the camera translation with exact "
                            "scene-edge boundary gradients "
                            "(grad/camera_edge.py); normalized-step "
                            "descent, --lr is the initial step length "
                            "in world units")
    p_fit.add_argument("--camera-rotation", action="store_true",
                       help="with --camera-edge: also fit the camera "
                            "rotation (axis-angle about the origin) via "
                            "camera_rotation_edge_grad")
    p_fit.add_argument("--lr-rot", type=float, default=None,
                       help="initial rotation step length in radians "
                            "(default --lr/300)")
    p_fit.add_argument("--edge-phi", type=int, default=512,
                       help="silhouette samples per edge-gradient step")
    p_fit.add_argument("--soft-tau", type=float, default=0.0,
                       help="use the soft-visibility loss (grad/soft.py) "
                       "with this temperature — enables silhouette-aware "
                       "GEOMETRY fitting (train fields like 'center')")
    p_fit.set_defaults(fn=cmd_fit)

    p_serve = sub.add_parser(
        "serve", help="HTTP render server (POST /render with JSON config)"
    )
    p_serve.add_argument("--host", default="127.0.0.1")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    _check_guided_args(ap, args)
    if args.platform != "auto":
        import jax

        jax.config.update("jax_platforms", args.platform)
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)

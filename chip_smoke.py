#!/usr/bin/env python3
"""On-card smoke test: the renderer's main paths, once each, on an NVIDIA GPU.

    python chip_smoke.py               # one GPU: phases 1-7
    python chip_smoke.py --devices 4   # four GPUs: phase 1, then phase 8 only

Phases (each prints its own lines; any failure raises and the script exits
non-zero — nothing carries on past a failed phase):

1. Device: JAX must report a GPU. Prints the JAX version, device kind and
   count, and the card's name and power limit from nvidia-smi.
2. Frame, jnp path: ``render`` at the north-star frame (Cornell box,
   1024x768, 512 spp, nee) through the CLI, in this process; set-up
   (compile) time, steady time and rays/s.
3. Frame, kernel path: the same with ``--pallas``. The compiled HLO must
   hold the Triton custom call (the kernel was compiled for the card, not
   interpreted); the image must agree with phase 2's; plus one quad scene.
4. Goldens: goldens/*_64x48x16_*_seed42.ppm on both paths, within a u8
   tolerance.
5. Fits: ``fit --pallas`` on materials, on sphere geometry through the
   geometry adjoint, and on one sphere by finite differences
   (``--fd-sphere``), 3 steps each; then one step of each adjoint kernel
   against jax.grad of grad/adjoint.render_linear at the fit config.
6. Serve: the HTTP server on a thread; three /render requests and
   /healthz.
7. GPU-only tests: ``pytest -m gpu tests/`` in this process.
8. (``--devices 4`` only) the sharded paths on four cards against the
   same renders on device 0 alone, and proof that every card did work.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
With no GPU (or outside this repository) the script exits non-zero
before printing it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NORTH_STAR = dict(scene="cornell_box", width=1024, height=768, spp=512,
                  estimator="nee")
# The gradient comparisons trace 16 bounces; the CLI fits keep the CLI's
# own path-depth cap (fit --pallas traces to RenderConfig.max_bounces).
FIT = dict(width=256, height=192, spp=16, bounces=16)

# Tolerances, each with its reason.
#
# Kernel vs jnp image: both paths draw the same per-sample counter-RNG
# stream, so they differ only where XLA:GPU and Triton contract FMAs
# differently (a grazing hit or a probe on a knife edge flips a path) and
# in float summation order. The linear mean images must agree to
# mean |d| <= IMG_MEAN_ABS and per-channel means to IMG_CHANNEL_MEAN.
IMG_MEAN_ABS = 1e-4
IMG_CHANNEL_MEAN = 1e-4
# Quad scene: the kernel's Gram solve uses reciprocal-multiply constants,
# the jnp path divides at run time, so more paths flip (statistical
# agreement, as tests/test_megakernel.py states for this preset).
QUAD_MEAN_ABS = 5e-3
QUAD_CHANNEL_MEAN = 2e-3
# Trace totals (extend + probe): same paths up to those flips.
TRACES_REL = 1e-4
# Goldens (rendered on the CPU): a flipped path moves a pixel's 16-sample
# mean by up to one sample's worth, so a few pixels may differ by many
# u8 levels; the image as a whole must not. Sphere scenes flip most (on an
# H100, 700 W: up to 1.7% of values differ, mean |d| up to 0.12 levels).
GOLDEN_FRAC_DIFF = 0.04      # share of u8 channel values that differ
GOLDEN_MEAN_ABS = 0.25       # mean |d| in u8 levels
# Material adjoint vs jax.grad through the jnp scan wavefront: same paths
# up to the FMA flips above, then float accumulation order.
MAT_LOSS_REL = 1e-3
MAT_GRAD_REL = 2e-2          # max |d| / max |g_jnp|, per table
# Geometry adjoint vs jax.grad: flip-class paths move geometry gradients
# far more than materials (tests/test_megakernel_geom.py states the same
# whole-image bound and direction check).
GEOM_GRAD_REL = 0.25
GEOM_GRAD_COS = 0.9
# Four cards vs device 0: identical sample sets (sharding-invariant RNG).
# The kernel path runs the same program on the same per-lane sample
# ranges, so only float summation order may differ; the jnp path is two
# differently fused XLA programs, so a rare path may also flip.
MESH_MEAN_ABS = 1e-6
MESH_PIXEL_ABS = 1e-5        # a pixel differing by more than this ...
MESH_FRAC_PIXELS = 1e-3      # ... may be at most this share of pixels


# ---------------------------------------------------------------------------
# Comparison helpers (pure numpy; tests/test_chip_smoke.py covers them).
# ---------------------------------------------------------------------------

def image_agreement(a, b) -> dict:
    """Mean |a - b| and the largest per-channel mean difference of two
    (h, w, 3) linear images."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    ch = np.abs(a.reshape(-1, a.shape[-1]).mean(0)
                - b.reshape(-1, b.shape[-1]).mean(0))
    return {"mean_abs": float(np.abs(a - b).mean()),
            "channel_mean": float(ch.max())}


def u8_agreement(got, golden) -> dict:
    """Share of differing u8 values, their mean |d| and max |d|."""
    got = np.asarray(got, np.int32)
    golden = np.asarray(golden, np.int32)
    if got.shape != golden.shape:
        raise AssertionError(f"shapes differ: {got.shape} vs {golden.shape}")
    d = np.abs(got - golden)
    return {"frac_diff": float((d > 0).mean()), "mean_abs": float(d.mean()),
            "max_abs": int(d.max())}


def grad_agreement(k, j) -> dict:
    """max |k - j| / max |j| and the cosine between two gradients."""
    k = np.asarray(k, np.float64).ravel()
    j = np.asarray(j, np.float64).ravel()
    scale = float(np.abs(j).max())
    if scale == 0.0:
        raise AssertionError("reference gradient is identically zero")
    nk, nj = float(np.linalg.norm(k)), float(np.linalg.norm(j))
    cos = float(k @ j / (nk * nj)) if nk > 0 else 0.0
    return {"rel": float(np.abs(k - j).max()) / scale, "cos": cos}


def check(name: str, value: float, limit: float, above: bool = False):
    """Print one measured quantity beside its limit; raise if outside."""
    ok = value >= limit if above else value <= limit
    rel = ">=" if above else "<="
    print(f"  {name} = {value:.6g} (limit {rel} {limit:g}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} = {value} outside {rel} {limit}")


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _cli(argv):
    from small_pathtracer_tpu.cli.main import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(argv)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"CLI {argv} returned {rc}")
    return dt


def phase_device(want: int):
    import jax

    from small_pathtracer_tpu.utils.device_info import (
        card_name_and_power_limit,
        require_gpu,
    )

    print("== phase 1: device", flush=True)
    devices = require_gpu()
    card = card_name_and_power_limit()
    print(f"  jax {jax.__version__}; {devices[0].device_kind} "
          f"x{len(devices)}", flush=True)
    print(f"  nvidia-smi: {card}", flush=True)
    if len(devices) < want:
        raise SystemExit(f"--devices {want} needs {want} GPUs; JAX has "
                         f"{len(devices)}")
    return devices, card


def _north_star():
    from small_pathtracer_tpu import RenderConfig, get_scene, make_camera

    ns = NORTH_STAR
    cfg = RenderConfig(width=ns["width"], height=ns["height"],
                       spp=ns["spp"], estimator=ns["estimator"])
    return (get_scene(ns["scene"]),
            make_camera(aspect=ns["width"] / ns["height"]), cfg)


def _render_argv(out, *extra):
    ns = NORTH_STAR
    return ["render", "--scene", ns["scene"], "--width", str(ns["width"]),
            "--height", str(ns["height"]), "--spp", str(ns["spp"]),
            "--estimator", ns["estimator"], "-o", str(out), *extra]


def phase_frame_jnp(tmp: Path, card: str):
    import jax.numpy as jnp

    from small_pathtracer_tpu.core import film
    from small_pathtracer_tpu.integrator.wavefront import render_regen

    print("== phase 2: frame, jnp path (render)", flush=True)
    out = tmp / "frame_jnp.ppm"
    setup = _cli(_render_argv(out))
    scene, cam, cfg = _north_star()
    if film.read_ppm(str(out)).shape != (cfg.height, cfg.width, 3):
        raise AssertionError("render wrote a wrong-sized image")
    best = None
    for _ in range(2):
        (img, tr), dt = _timed(render_regen, scene, cam, cfg,
                               jnp.uint32(cfg.seed))
        best = dt if best is None else min(best, dt)
    traces = float(np.asarray(tr).sum())
    print(f"  set-up (CLI call, compile included) {setup:.3f} s; steady "
          f"{best:.4f} s; {traces / best / 1e6:.1f} Mrays/s [{card}]",
          flush=True)
    return np.asarray(img) / cfg.spp, traces


def _triton_in_hlo(scene, cam, cfg) -> str:
    """Compiled HLO text of the kernel render; the Triton custom call must
    be in it (an interpreted kernel would show no such call)."""
    import jax.numpy as jnp

    from small_pathtracer_tpu.ops import megakernel as mk

    use_tab, _, tables = mk._scene_inputs(scene, cam, cfg)
    run = mk._build_render(scene, cam, cfg, cfg.spp, use_tab)
    txt = run.lower(jnp.uint32(cfg.seed), jnp.uint32(0),
                    *tables).compile().as_text()
    line = next((ln.strip() for ln in txt.splitlines()
                 if "xla.gpu.triton" in ln), "")
    if not line:
        raise AssertionError("no Triton custom call in the compiled HLO: "
                             "the kernel was not compiled for the GPU")
    return line


def phase_frame_kernel(tmp: Path, card: str, img_jnp, traces_jnp):
    from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu.integrator.wavefront import render_regen
    from small_pathtracer_tpu.ops.megakernel import render_pallas, trace_totals

    import jax.numpy as jnp

    print("== phase 3: frame, kernel path (render --pallas)", flush=True)
    out = tmp / "frame_kernel.ppm"
    setup = _cli(_render_argv(out, "--pallas"))
    scene, cam, cfg = _north_star()
    line = _triton_in_hlo(scene, cam, cfg)
    print(f"  compiled HLO holds the Triton call: {line[:100]}...",
          flush=True)
    best = None
    for _ in range(2):
        (img, tr), dt = _timed(render_pallas, scene, cam, cfg, cfg.seed)
        best = dt if best is None else min(best, dt)
    traces = float(trace_totals(tr).sum())
    print(f"  set-up (CLI call, compile included) {setup:.3f} s; steady "
          f"{best:.4f} s; {traces / best / 1e6:.1f} Mrays/s [{card}]",
          flush=True)
    agree = image_agreement(np.asarray(img) / cfg.spp, img_jnp)
    check("kernel vs jnp mean |d|", agree["mean_abs"], IMG_MEAN_ABS)
    check("kernel vs jnp channel-mean |d|", agree["channel_mean"],
          IMG_CHANNEL_MEAN)
    check("kernel vs jnp trace total rel |d|",
          abs(traces - traces_jnp) / traces_jnp, TRACES_REL)

    # One scene with quads (tilted area light).
    qcfg = RenderConfig(width=256, height=192, spp=64, estimator="nee",
                        seed=1)
    qscene = get_scene("cornell_tilted_light")
    qcam = make_camera(aspect=256 / 192)
    a, _ = render_regen(qscene, qcam, qcfg, jnp.uint32(1))
    b, _ = render_pallas(qscene, qcam, qcfg, 1)
    agree = image_agreement(np.asarray(b) / qcfg.spp,
                            np.asarray(a) / qcfg.spp)
    check("quad scene mean |d|", agree["mean_abs"], QUAD_MEAN_ABS)
    check("quad scene channel-mean |d|", agree["channel_mean"],
          QUAD_CHANNEL_MEAN)


GOLDEN_CASES = [
    ("cornell_box_64x48x16_nee_seed42.ppm", "cornell_box", {}),
    ("cornell_spheres_64x48x16_nee_seed42.ppm", "cornell_spheres", {}),
    ("cornell_spheres_64x48x16_nee_tentdof_seed42.ppm", "cornell_spheres",
     dict(pixel_filter="tent", aperture=6.0, focus_dist=121.0)),
    ("smallpt_original_64x48x16_cosine_seed42.ppm", "smallpt_original",
     dict(estimator="cosine")),
]


def phase_goldens():
    import small_pathtracer_tpu as spt
    from small_pathtracer_tpu.core import film

    print("== phase 4: goldens (jnp and kernel paths)", flush=True)
    for fname, scene_name, extra in GOLDEN_CASES:
        golden = film.read_ppm(str(ROOT / "goldens" / fname))
        kw = dict(width=64, height=48, spp=16, estimator="nee", seed=42)
        kw.update(extra)
        for pallas in (False, True):
            cfg = spt.RenderConfig(use_pallas=pallas, **kw)
            img, _ = spt.render(spt.get_scene(scene_name),
                                spt.make_camera(aspect=64 / 48), cfg)
            got = np.asarray(film.tonemap_u8(img))
            a = u8_agreement(got, golden)
            tag = f"{fname} {'kernel' if pallas else 'jnp'}"
            print(f"  {tag}: max |d| {a['max_abs']} u8", flush=True)
            check(f"{tag} share of differing values", a["frac_diff"],
                  GOLDEN_FRAC_DIFF)
            check(f"{tag} mean |d| (u8)", a["mean_abs"], GOLDEN_MEAN_ABS)


def _fit_argv(*extra):
    return ["fit", "--pallas", "--steps", "3", "--width", str(FIT["width"]),
            "--height", str(FIT["height"]), "--spp", str(FIT["spp"]),
            *extra]


def phase_fits():
    import jax
    import jax.numpy as jnp

    from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu.grad.adjoint import render_linear
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu.ops.megakernel_grad import (
        loss_and_material_grads,
        pack_materials,
    )

    print("== phase 5: fits (kernel adjoints vs jax.grad)", flush=True)
    dt = _cli(_fit_argv("--train", "emission,albedo"))
    print(f"  fit --pallas materials, 3 steps: {dt:.3f} s (compile "
          "included)", flush=True)
    dt = _cli(_fit_argv("--scene", "cornell_spheres", "--train",
                        "center,radius"))
    print(f"  fit --pallas geometry (adjoint), 3 steps: {dt:.3f} s "
          "(compile included)", flush=True)
    dt = _cli(_fit_argv("--scene", "cornell_spheres", "--fd-sphere", "0",
                        "--train", "center,radius"))
    print(f"  fit --pallas --fd-sphere 0 (finite differences), 3 steps: "
          f"{dt:.3f} s (compile included)", flush=True)

    w, h = FIT["width"], FIT["height"]
    cam = make_camera(aspect=w / h)
    cfg = RenderConfig(width=w, height=h, spp=FIT["spp"], estimator="nee",
                       max_bounces=FIT["bounces"], seed=3)

    # Material adjoint: one step vs jax.grad at the same config.
    scene = get_scene("cornell_box")
    bright = scene._replace(rects=scene.rects._replace(
        emission=scene.rects.emission * 1.4))
    target = render_linear(bright, cam, cfg, jnp.uint32(9), FIT["bounces"])
    l_k, ga_k, ge_k = loss_and_material_grads(scene, cam, cfg,
                                              jnp.uint32(cfg.seed), target)

    def mat_loss(sc):
        img = render_linear(sc, cam, cfg, jnp.uint32(cfg.seed),
                            FIT["bounces"])
        return jnp.mean((img - target) ** 2)

    l_j, g = jax.value_and_grad(mat_loss, allow_int=True)(scene)
    ga_j, ge_j = pack_materials(g)
    check("material loss rel |d|",
          abs(float(l_k) - float(l_j)) / abs(float(l_j)), MAT_LOSS_REL)
    # The light's own albedo row is excluded: a knife-edge artifact of the
    # reference's light-plane mismatch (tests/test_megakernel_grad.py).
    light = int(np.asarray(scene.light.light_obj_id))
    ga_k = np.asarray(ga_k).copy()
    ga_j = np.asarray(ga_j).copy()
    ga_k[light] = ga_j[light] = 0.0
    check("albedo grad rel |d|", grad_agreement(ga_k, ga_j)["rel"],
          MAT_GRAD_REL)
    check("emission grad rel |d|", grad_agreement(ge_k, ge_j)["rel"],
          MAT_GRAD_REL)

    # Geometry adjoint: one step vs jax.grad on sphere center/radius.
    gscene = get_scene("cornell_spheres")
    gcfg = dataclasses.replace(cfg, sphere_table="on")
    zero = np.zeros((h, w, 3), np.float32)
    _, gk = mgeo.loss_and_geom_grads(gscene, cam, gcfg, cfg.seed, zero)

    def geo_loss(cen, rad):
        s2 = gscene._replace(spheres=gscene.spheres._replace(
            center=cen, radius=rad))
        img = render_linear(s2, cam, gcfg, jnp.uint32(cfg.seed),
                            FIT["bounces"])
        return jnp.mean(img ** 2)

    gc, gr = jax.grad(geo_loss, argnums=(0, 1))(gscene.spheres.center,
                                                gscene.spheres.radius)
    agree = grad_agreement(
        np.concatenate([np.ravel(gk.spheres.center),
                        np.ravel(gk.spheres.radius)]),
        np.concatenate([np.ravel(gc), np.ravel(gr)]),
    )
    check("geometry grad rel |d|", agree["rel"], GEOM_GRAD_REL)
    check("geometry grad cosine", agree["cos"], GEOM_GRAD_COS, above=True)


def phase_serve():
    from small_pathtracer_tpu.cli.server import make_server

    print("== phase 6: serve", flush=True)
    httpd = make_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        for i, pallas in enumerate((False, False, True)):
            req = json.dumps({"scene": "cornell_box", "width": 256,
                              "height": 256, "spp": 32,
                              "use_pallas": pallas,
                              "format": "ppm"}).encode()
            t0 = time.perf_counter()
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/render", data=req, timeout=600
            ) as r:
                status, body = r.status, r.read()
            dt = time.perf_counter() - t0
            head = body.split(b"\n", 3)
            if status != 200 or head[0] != b"P3" or head[1] != b"256 256":
                raise AssertionError(f"bad /render response {status} "
                                     f"{head[:2]}")
            print(f"  POST /render #{i} (use_pallas={pallas}): {status}, "
                  f"256x256, {dt:.3f} s", flush=True)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            stats = json.loads(r.read())
        if r.status != 200 or stats.get("requests") != 3:
            raise AssertionError(f"/healthz: {r.status} {stats}")
        print(f"  GET /healthz: {stats}", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()


def phase_gpu_tests():
    import pytest

    print("== phase 7: pytest -m gpu tests/", flush=True)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(ROOT / "tests")])
    if rc != 0:
        raise AssertionError(f"pytest -m gpu returned {rc}")


def _mesh_check(tag, a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    check(f"{tag} mean |d|", float(d.mean()), MESH_MEAN_ABS)
    check(f"{tag} share of pixels with |d| > {MESH_PIXEL_ABS:g}",
          float((d.max(axis=-1) > MESH_PIXEL_ABS).mean()), MESH_FRAC_PIXELS)


def phase_four_cards(devices, tmp: Path):
    import jax
    import jax.numpy as jnp

    from small_pathtracer_tpu import get_scene
    from small_pathtracer_tpu.integrator.wavefront import render_regen
    from small_pathtracer_tpu.ops.megakernel import (
        render_pallas,
        render_pallas_sharded,
        trace_totals,
    )
    from small_pathtracer_tpu.ops.megakernel_grad import (
        loss_and_material_grads,
        material_train_step_sharded,
        pack_materials,
    )
    from small_pathtracer_tpu.parallel.mesh import make_mesh
    from small_pathtracer_tpu.parallel.sharded import render_sharded

    print("== phase 8: four cards", flush=True)
    scene, cam, cfg = _north_star()
    devs = devices[:4]

    dt = _cli(_render_argv(tmp / "mesh_kernel.ppm", "--mesh", "4x1",
                           "--pallas"))
    print(f"  render --mesh 4x1 --pallas: {dt:.3f} s (compile included)",
          flush=True)
    mesh = make_mesh(devs, mesh_shape=(4, 1))
    render_pallas_sharded(scene, cam, cfg, mesh, cfg.seed)
    (img4, tr4), dt4 = _timed(render_pallas_sharded, scene, cam, cfg, mesh,
                              cfg.seed)
    shard_devs = sorted(s.device.id for s in img4.addressable_shards)
    print(f"  output shards on devices {shard_devs}; steady {dt4:.4f} s",
          flush=True)
    if len(set(shard_devs)) != 4:
        raise AssertionError(f"shards on {shard_devs}, not four devices")
    with jax.default_device(devs[0]):
        render_pallas(scene, cam, cfg, cfg.seed)
        (img1, tr1), dt1 = _timed(render_pallas, scene, cam, cfg, cfg.seed)
    print(f"  same frame on device 0 alone: {dt1:.4f} s", flush=True)
    _mesh_check("4x1 kernel vs device 0",
                np.asarray(img4).reshape(img1.shape) / cfg.spp,
                np.asarray(img1) / cfg.spp)
    tr4, tr1 = trace_totals(tr4), trace_totals(tr1)
    if not np.array_equal(tr4, tr1):
        raise AssertionError(f"trace totals differ: {tr4} vs {tr1}")

    dt = _cli(_render_argv(tmp / "mesh_jnp.ppm", "--mesh", "2x2"))
    print(f"  render --mesh 2x2: {dt:.3f} s (compile included)", flush=True)
    mesh22 = make_mesh(devs, mesh_shape=(2, 2))
    render_sharded(scene, cam, cfg, mesh22)
    (imgj4, _), dtj4 = _timed(render_sharded, scene, cam, cfg, mesh22)
    with jax.default_device(devs[0]):
        render_regen(scene, cam, cfg, jnp.uint32(cfg.seed))
        (imgj1, _), dtj1 = _timed(render_regen, scene, cam, cfg,
                                  jnp.uint32(cfg.seed))
    print(f"  steady: 2x2 {dtj4:.4f} s, device 0 alone {dtj1:.4f} s",
          flush=True)
    _mesh_check("2x2 jnp vs device 0", np.asarray(imgj4),
                np.clip(np.asarray(imgj1) / cfg.spp, 0.0, 1.0))

    # Sharded material fit step vs the single-device adjoint.
    w, h = FIT["width"], FIT["height"]
    from small_pathtracer_tpu import RenderConfig, make_camera

    fcfg = RenderConfig(width=w, height=h, spp=FIT["spp"], estimator="nee",
                        max_bounces=FIT["bounces"], seed=3)
    fcam = make_camera(aspect=w / h)
    fscene = get_scene("cornell_box")
    target = np.zeros((h, w, 3), np.float32)
    step = material_train_step_sharded(fscene, fcam, fcfg,
                                       make_mesh(devs, mesh_shape=(2, 2)),
                                       target)
    alb, emi = pack_materials(fscene)
    step(alb, emi, 3)
    (l4, ga4, ge4), dts = _timed(step, alb, emi, 3)
    with jax.default_device(devs[0]):
        loss_and_material_grads(fscene, fcam, fcfg, jnp.uint32(3), target)
        (l1, ga1, ge1), dtd = _timed(loss_and_material_grads, fscene, fcam,
                                     fcfg, jnp.uint32(3), target)
    print(f"  material step: 2x2 {dts:.4f} s, device 0 {dtd:.4f} s",
          flush=True)
    check("sharded material loss rel |d|",
          abs(float(l4) - float(l1)) / abs(float(l1)), 1e-5)
    check("sharded albedo grad rel |d|", grad_agreement(ga4, ga1)["rel"],
          1e-4)
    check("sharded emission grad rel |d|", grad_agreement(ge4, ge1)["rel"],
          1e-4)

    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    print(f"  peak bytes in use per device: {peaks}", flush=True)
    if min(peaks) <= 0:
        raise AssertionError(f"a device did no work: {peaks}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=[1, 4],
                    help="4: run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from small_pathtracer_tpu.utils.compile_cache import enable_compile_cache

    devices, card = phase_device(args.devices)
    enable_compile_cache()
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        if args.devices == 4:
            phase_four_cards(devices, tmp)
        else:
            img_jnp, traces_jnp = phase_frame_jnp(tmp, card)
            phase_frame_kernel(tmp, card, img_jnp, traces_jnp)
            phase_goldens()
            phase_fits()
            phase_serve()
            phase_gpu_tests()
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

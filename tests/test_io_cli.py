"""Config surface: JSON scene loader, CLI, checkpoints, metrics."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from python_ray_tracer_jax import RenderConfig, render
from python_ray_tracer_jax.io import load_scene, load_settings
from python_ray_tracer_jax.utils.checkpoint import load_checkpoint, save_checkpoint
from python_ray_tracer_jax.utils.image import load_png, save_png
from python_ray_tracer_jax.utils.metrics import MetricsLogger, rays_per_second

SCENE_JSON = [
    {
        "type": "Sphere",
        "centerXYZ": [0.55, 0.5, 3.0],
        "radius": 1.0,
        "colorRGB": [1.0, 1.0, 1.0],
        "reflection": 0.0,
        "roughness": 0.01,
        "texture": "",
        "diffuse_gain": 0.0,
    },
    {
        "type": "Sphere",
        "centerXYZ": [-0.45, 0.1, 1.0],
        "radius": 0.4,
        "colorRGB": [1.0, 0.0, 0.0],
        "roughness": 0.1,
        "specular_gain": 1.0,
        "diffuse_gain": 0.0,
    },
    {
        "type": "Sphere",
        "centerXYZ": [0.0, -99999.5, 0.0],
        "radius": 99999.0,
        "roughness": 0.5,
        "specular_gain": 0.1,
        "diffuse_gain": 1.0,
        "texture": "checker",
    },
    {"type": "Light", "centerXYZ": [-2.0, 1.0, 2.0], "intensityRGB": [1.0, 1.0, 1.0]},
    {"type": "DomeLight", "intensity": 0.1, "colorRGB": [1.0, 1.0, 1.0]},
    {"type": "Camera", "positionXYZ": [0.0, 0.2, -2.0]},
]


def test_json_scene_matches_builtin(tmp_path):
    """The reference scene written as JSON renders identically to the
    builtin literal (the de-facto schema round-trip check)."""
    from python_ray_tracer_jax.models.scenes import reference_scene

    path = tmp_path / "scene.json"
    path.write_text(json.dumps(SCENE_JSON))
    loaded = load_scene(path, width=96, height=54, dtype=jnp.float32)
    builtin = reference_scene(96, 54, dtype=jnp.float32)
    cfg = RenderConfig(max_depth=3, dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(render(loaded, cfg)), np.asarray(render(builtin, cfg)), rtol=0, atol=1e-7
    )


def test_settings_roundtrip(tmp_path):
    path = tmp_path / "settings.json"
    path.write_text(
        json.dumps(
            {
                "image_width": 120,
                "image_height": 60,
                "max_specular_depth": 4,
                "dtype": "float32",
                "visibility": "smooth",
                "output_path": "x.png",
            }
        )
    )
    cfg, extras = load_settings(path)
    assert cfg.max_depth == 4
    assert cfg.visibility == "smooth"
    assert (extras["width"], extras["height"]) == (120, 60)


def test_image_texture_sphere(tmp_path):
    """Image-textured sphere (the NumpyTexturedSphere feature spec,
    shape.py:57-90 — dead code upstream, live here)."""
    tex = (np.linspace(0, 255, 32 * 16 * 3).reshape(16, 32, 3)).astype(np.uint8)
    save_png(tex / 255.0, tmp_path / "tex.png")
    scene_json = [
        {
            "type": "Sphere",
            "centerXYZ": [0.0, 0.0, 3.0],
            "radius": 1.0,
            "texture": "tex.png",
            "diffuse_gain": 1.0,
        },
        {"type": "Light", "centerXYZ": [-2.0, 1.0, 2.0], "intensityRGB": [1, 1, 1]},
    ]
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene_json))
    scene = load_scene(path, width=64, height=36, dtype=jnp.float32)
    assert scene.texture_atlas.shape[0] == 1
    img = np.asarray(render(scene, RenderConfig(max_depth=1, dtype=jnp.float32)))
    assert np.isfinite(img).all()
    assert img.max() > 0.01


def test_cli_render(tmp_path):
    from python_ray_tracer_jax.cli import main

    out = tmp_path / "out.png"
    metrics = tmp_path / "m.jsonl"
    rc = main(
        [
            "render",
            "--builtin", "reference",
            "--width", "64", "--height", "36", "--depth", "2",
            "-o", str(out),
            "--metrics", str(metrics),
        ]
    )
    assert rc == 0
    assert load_png(out).shape == (36, 64, 3)
    rec = json.loads(metrics.read_text().splitlines()[-1])
    assert rec["event"] == "render"
    assert rec["primary_rays_per_s"] > 0


def test_cli_render_sharded_mesh(tmp_path):
    """--ray-shards/--sphere-shards reach render_sharded from the CLI
    (VERDICT r2 item 5): 4x2 mesh on the virtual 8-device CPU backend,
    output identical to the single-device CLI render."""
    from python_ray_tracer_jax.cli import main

    out_single = tmp_path / "single.png"
    out_mesh = tmp_path / "mesh.png"
    base = ["render", "--builtin", "reference", "--width", "64", "--height", "36",
            "--depth", "2", "--spp", "2"]
    assert main(base + ["-o", str(out_single)]) == 0
    assert main(base + ["--ray-shards", "4", "--sphere-shards", "2", "-o", str(out_mesh)]) == 0
    a, b = load_png(out_single), load_png(out_mesh)
    assert a.shape == (36, 64, 3)
    np.testing.assert_array_equal(a, b)


def test_cli_optimize_sharded_mesh(tmp_path):
    """--ray-shards on optimize wires the mesh into make_loss_fn."""
    from python_ray_tracer_jax.cli import main
    from python_ray_tracer_jax.models.scenes import reference_scene
    from python_ray_tracer_jax.render import render
    from python_ray_tracer_jax.utils.image import save_png

    scene = reference_scene(48, 27, dtype=jnp.float32)
    target = tmp_path / "target.png"
    save_png(np.asarray(render(scene, RenderConfig(max_depth=2, dtype=jnp.float32))), target)
    metrics = tmp_path / "m.jsonl"
    rc = main([
        "optimize", "--builtin", "reference", "--width", "48", "--height", "27",
        "--depth", "2", "--target", str(target), "--steps", "2",
        "--ray-shards", "8", "--metrics", str(metrics),
    ])
    assert rc == 0
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert sum(r["event"] == "step" for r in recs) == 2


def test_cli_optimize_with_checkpoint_resume(tmp_path):
    from python_ray_tracer_jax.cli import main
    from python_ray_tracer_jax.models.scenes import reference_scene

    target = tmp_path / "target.png"
    scene = reference_scene(48, 27, dtype=jnp.float32)
    save_png(
        np.asarray(render(scene, RenderConfig(max_depth=2, dtype=jnp.float32, visibility="smooth"))),
        target,
    )
    ckpt = tmp_path / "state.npz"
    common = [
        "optimize",
        "--builtin", "reference",
        "--width", "48", "--height", "27", "--depth", "2",
        "--visibility", "smooth",
        "--target", str(target),
        "--lr", "1e-3",
        "--checkpoint", str(ckpt),
        "--checkpoint-every", "2",
    ]
    assert main(common + ["--steps", "3"]) == 0
    assert ckpt.exists()
    # Resume: runs steps 3..4 only (fault-tolerant restart, SURVEY §5.3/5.4).
    assert main(common + ["--steps", "5"]) == 0


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": jnp.arange(5.0), "b": (jnp.ones((2, 3)), jnp.asarray(7, jnp.int32))}
    save_checkpoint(tmp_path / "c.npz", state)
    loaded = load_checkpoint(tmp_path / "c.npz", state)
    np.testing.assert_array_equal(np.asarray(loaded["a"]), np.arange(5.0))
    assert int(loaded["b"][1]) == 7


def test_checkpoint_structure_mismatch_raises(tmp_path):
    """Same leaf count, different structure (e.g. a different --train-fields
    selection): the saved treedef string must reject the load (ADVICE r1)."""
    save_checkpoint(tmp_path / "c.npz", {"a": jnp.arange(3.0), "b": jnp.ones(())})
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(tmp_path / "c.npz", {"a": jnp.arange(3.0), "z": jnp.ones(())})


def test_mixed_size_textures(tmp_path):
    """Two differently-sized image textures: the smaller one must sample its
    own native extent, not the zero-padded atlas slot (ADVICE r1).  A far
    off-screen sphere carrying a larger texture must not change how the
    visible sphere's texture renders."""
    rng = np.random.default_rng(11)
    small = rng.uniform(0.2, 1.0, (8, 16, 3))
    big = rng.uniform(0.2, 1.0, (32, 64, 3))
    save_png(small, tmp_path / "small.png")
    save_png(big, tmp_path / "big.png")
    visible = {
        "type": "Sphere", "centerXYZ": [0.0, 0.0, 3.0], "radius": 1.0,
        "texture": "small.png", "diffuse_gain": 1.0,
    }
    light = {"type": "Light", "centerXYZ": [-2.0, 1.0, 2.0], "intensityRGB": [1, 1, 1]}
    offscreen = {
        "type": "Sphere", "centerXYZ": [0.0, 0.0, -500.0], "radius": 0.5,
        "texture": "big.png", "diffuse_gain": 1.0,
    }
    (tmp_path / "alone.json").write_text(json.dumps([visible, light]))
    (tmp_path / "mixed.json").write_text(json.dumps([visible, offscreen, light]))

    cfg = RenderConfig(max_depth=2, dtype=jnp.float32)
    img_alone = np.asarray(render(load_scene(tmp_path / "alone.json", width=64, height=36), cfg))
    scene_mixed = load_scene(tmp_path / "mixed.json", width=64, height=36)
    assert scene_mixed.texture_atlas.shape[1:3] == (32, 64)  # padded to max
    np.testing.assert_array_equal(np.asarray(scene_mixed.texture_hw), [[8, 16], [32, 32 * 2]])
    img_mixed = np.asarray(render(scene_mixed, cfg))
    np.testing.assert_allclose(img_mixed, img_alone, rtol=1e-6, atol=1e-6)


def test_metrics_logger(tmp_path):
    m = MetricsLogger(tmp_path / "log.jsonl")
    m.log("step", loss=0.5)
    m.log("step", loss=0.25, **rays_per_second(1000, 3, 0.5))
    lines = [json.loads(line) for line in (tmp_path / "log.jsonl").read_text().splitlines()]
    assert len(lines) == 2
    assert lines[1]["trace_segments_per_s"] == 12000.0


def test_all_effects_scene_and_main_module(tmp_path):
    """The all-effects builtin renders finitely; `python -m` entry works."""
    import subprocess
    import sys

    from python_ray_tracer_jax.models.scenes import all_effects_scene

    scene = all_effects_scene(64, 36)
    img = np.asarray(render(scene, RenderConfig(max_depth=2, dtype=jnp.float32)))
    assert np.isfinite(img).all() and img.max() > 0.1

    out = tmp_path / "m.png"
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "python_ray_tracer_jax", "render", "--builtin", "all_effects",
         "--width", "48", "--height", "27", "--depth", "1", "-o", str(out)],
        cwd=Path(__file__).resolve().parent.parent, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    assert load_png(out).shape == (27, 48, 3)


def test_cli_optimize_train_fields(tmp_path):
    """--train-fields restricts the optimized parameter groups."""
    from python_ray_tracer_jax.cli import main
    from python_ray_tracer_jax.models.scenes import reference_scene

    target = tmp_path / "t.png"
    scene = reference_scene(32, 18, dtype=jnp.float32)
    save_png(
        np.asarray(render(scene, RenderConfig(max_depth=1, dtype=jnp.float32, visibility="smooth"))),
        target,
    )
    rc = main(
        [
            "optimize", "--builtin", "reference",
            "--width", "32", "--height", "18", "--depth", "1",
            "--visibility", "smooth", "--target", str(target),
            "--steps", "2", "--lr", "1e-3",
            "--train-fields", "spheres.specular_gain,lights.point_position",
        ]
    )
    assert rc == 0
    # invalid selection errors out cleanly
    rc = main(
        [
            "optimize", "--builtin", "reference",
            "--width", "32", "--height", "18", "--depth", "1",
            "--visibility", "smooth", "--target", str(target),
            "--steps", "1", "--train-fields", "nonsense",
        ]
    )
    assert rc == 2

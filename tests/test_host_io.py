"""Host-side pieces that must run with nothing beyond numpy: PGM/PPM and PNG
I/O without PIL, the renderer without cv2, the compile-cache directory,
and the native ingest library's rebuild on a source change."""

import importlib
import sys

import jax
import numpy as np
import pytest

from tpusfm.io import images as im_io
from tpusfm.io import native_ingest
from tpusfm.utils import compile_cache

rng = np.random.default_rng(3)


@pytest.fixture
def no_pil_no_native(monkeypatch):
    """PIL unimportable and the native decoder unavailable."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setattr(im_io, "_native_batch", lambda *a, **k: None)


def _write_pnm16(path, img):
    magic = "P5" if img.ndim == 2 else "P6"
    with open(path, "wb") as f:
        f.write(f"{magic}\n# comment\n{img.shape[1]} {img.shape[0]}\n65535\n".encode())
        f.write(img.astype(">u2").tobytes())


@pytest.mark.parametrize("shape", [(13, 17), (13, 17, 3)])
@pytest.mark.parametrize("bits", [8, 16])
def test_pnm_round_trip(tmp_path, shape, bits):
    path = tmp_path / ("a.pgm" if len(shape) == 2 else "a.ppm")
    if bits == 8:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        im_io.write_pnm(path, img)
    else:
        img = rng.integers(0, 65536, shape).astype(np.uint16)
        _write_pnm16(path, img)
    out = im_io.read_pnm(path)
    assert out.dtype == img.dtype
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("ext", [".pgm", ".ppm"])
def test_load_pnm_without_pil(tmp_path, no_pil_no_native, ext):
    imgs = rng.integers(0, 256, (3, 20, 30, 3)).astype(np.uint8)
    if ext == ".pgm":
        imgs = imgs[..., 0]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(tmp_path / f"v{i}{ext}")
        im_io.write_pnm(paths[-1], im)
    gray = im_io.load_images_gray(im_io.list_images(tmp_path))
    rgb = im_io.load_images_rgb(im_io.list_images(tmp_path))
    f = imgs.astype(np.float32) / 255.0
    want = f if ext == ".pgm" else (0.299 * f[..., 0] + 0.587 * f[..., 1]
                                    + 0.114 * f[..., 2])
    np.testing.assert_allclose(gray, want, atol=1e-6)
    want_rgb = imgs if ext == ".ppm" else np.repeat(imgs[..., None], 3, -1)
    np.testing.assert_array_equal(rgb, want_rgb)


def test_read_image_record_without_pil(tmp_path, no_pil_no_native):
    p = tmp_path / "v.ppm"
    im_io.write_pnm(p, np.zeros((48, 64, 3), np.uint8))
    rec = im_io.read_image_record(p, focal_prior_px=55.0)
    assert (rec.width, rec.height, rec.focal_px) == (64, 48, 55.0)
    assert rec.camera_model is None and rec.gps is None


def test_other_formats_name_pil_when_it_is_missing(tmp_path, no_pil_no_native):
    p = tmp_path / "v.png"
    im_io.write_png(p, np.zeros((4, 4), np.uint8))
    with pytest.raises(ImportError, match=r"\.png.*PIL"):
        im_io.read_image_record(p)
    with pytest.raises(ImportError, match=r"\.png.*PIL"):
        im_io.load_images_gray([p])


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_write_png_decodes(tmp_path, channels):
    Image = pytest.importorskip("PIL.Image")
    shape = (21, 34) if channels is None else (21, 34, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    im_io.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")), img)


def test_renderer_runs_without_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    from tpusfm.utils import synth_render

    sr = importlib.reload(synth_render)
    images, gt = sr.render_orbit_images(n_views=3, img_h=60, img_w=80,
                                        focal=70.0, arc_deg=40.0, seed=2)
    assert images.shape == (3, 60, 80) and images.dtype == np.float32
    assert 0.0 <= images.min() and images.max() <= 1.0
    covered = np.isfinite(gt["depth"])
    assert covered.mean() > 0.3
    assert np.all(gt["depth"][covered] > 0.1)
    assert images[0].std() > 0.05 and not np.allclose(images[0], images[1])


def test_resize_and_warp_match_opencv():
    cv2 = pytest.importorskip("cv2")
    from tpusfm.utils import synth_render as sr

    n = rng.normal(size=(8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        sr._resize_cubic(n, 96),
        cv2.resize(n, (96, 96), interpolation=cv2.INTER_CUBIC), atol=1e-5)
    tex = sr._multiscale_texture(128, 1)
    src = np.array([[0, 0], [127, 0], [0, 127], [127, 127]], np.float32)
    dst = np.array([[10, 5], [70, 12], [8, 50], [66, 58]], np.float32)
    H = sr._perspective_transform(src, dst)
    np.testing.assert_allclose(H, cv2.getPerspectiveTransform(src, dst),
                               atol=1e-9)
    xs, ys = np.meshgrid(np.arange(80), np.arange(60))
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    ours = sr._warp_perspective(tex, H, pix, border=-1.0)
    ref = cv2.warpPerspective(tex, H, (80, 60), flags=cv2.INTER_LINEAR,
                              borderMode=cv2.BORDER_CONSTANT, borderValue=-1.0)
    assert np.mean(np.abs(ours - ref) < 1e-3) > 0.999


def _recorded_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_uses_env_dir_verbatim(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "given"))
    calls = _recorded_updates(monkeypatch)
    assert compile_cache.enable() == str(tmp_path / "given")
    assert "jax_compilation_cache_dir" not in calls  # JAX reads the variable
    assert not (tmp_path / "given").exists()


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_compile_cache_default_dir(monkeypatch, platform):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    calls = _recorded_updates(monkeypatch)
    d = compile_cache.enable()
    if platform == "cpu":  # AOT executables are tied to the host's CPU
        assert d.startswith(compile_cache.DEFAULT_DIR + "/")
        assert d != compile_cache.DEFAULT_DIR
    else:
        assert d == compile_cache.DEFAULT_DIR
    assert calls["jax_compilation_cache_dir"] == d
    assert compile_cache.DEFAULT_DIR.endswith(".jax_cache")


@pytest.fixture
def fake_native(tmp_path, monkeypatch):
    """native_ingest pointed at a scratch tree whose build script writes a
    fake library and counts its runs."""
    root = tmp_path / "native"
    (root / "src").mkdir(parents=True)
    (root / "src" / "ingest.cpp").write_text("// v1\n")
    build = root / "build.sh"
    build.write_text('echo built >> "$(dirname "$0")/builds.log"\n'
                     'printf lib > "$1"\n')
    lib = root / "lib" / "libtpusfm_ingest.so"
    lib.parent.mkdir()
    monkeypatch.setattr(native_ingest, "_ROOT", tmp_path)
    monkeypatch.setattr(native_ingest, "_BUILD_SH", build)
    monkeypatch.setattr(native_ingest, "_LIB_PATH", lib)
    monkeypatch.setattr(native_ingest, "_STAMP",
                        lib.with_name(lib.name + ".stamp"))

    def n_builds():
        log = root / "builds.log"
        return len(log.read_text().splitlines()) if log.exists() else 0

    return root, lib, n_builds


def test_native_library_rebuilds_only_on_source_change(fake_native):
    root, lib, n_builds = fake_native
    lib.write_text("left from another machine")  # no stamp: stale
    assert native_ingest._build_if_stale() and lib.read_text() == "lib"
    assert native_ingest._build_if_stale() and n_builds() == 1
    (root / "src" / "ingest.cpp").write_text("// v2\n")
    assert native_ingest._build_if_stale() and n_builds() == 2


def test_native_library_failed_build_is_not_loaded(fake_native):
    root, lib, _ = fake_native
    lib.write_text("stale")
    (root / "build.sh").write_text("exit 1\n")
    assert not native_ingest._build_if_stale()
    assert not lib.exists()


def test_main_path_imports_without_optional_packages():
    """run_sparse, the staged pipeline, the CLI, the service, dense and mesh
    import with the packages a JAX installation need not have made
    unimportable (image, vision and JAX-ecosystem libraries)."""
    import subprocess

    code = r'''
import sys
absent = {"PIL", "cv2", "flax", "orbax", "optax", "chex", "einops", "torch",
          "tensorflow", "skimage", "imageio", "triton"}
class Absent:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in absent:
            raise ModuleNotFoundError(f"main path imported {name}")
        return None
sys.meta_path.insert(0, Absent())
import tpusfm.pipeline.sparse, tpusfm.pipeline.staged, tpusfm.cli
import tpusfm.service.http_server, tpusfm.dense.depth, tpusfm.dense.meshing
import tpusfm.dense.texturing, tpusfm.utils.synth_render, tpusfm.io.images
print("ok")
'''
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=str(__import__("pathlib").Path(__file__).parent.parent))
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]

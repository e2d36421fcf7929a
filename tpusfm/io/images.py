"""Image ingest: loading, EXIF focal priors, sensor-width database.

Capability parity with ``readImagesCluster``
(src/sparseBuilder/sparseBuilder.cpp:314-573): enumerate an image
directory, read sizes, extract EXIF focal length and camera model, map the
model to a sensor width through a database, and derive the focal prior in
pixels as ``max(w, h) * focal_mm / sensor_width_mm`` (.cpp:455) — falling
back to a caller-supplied prior (the reference hard-codes 2905.88 at
main.cpp:124) or a default FOV guess.  GPS EXIF priors (.cpp getGPS
.cpp:112) are parsed when present.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm"}
# Binary PGM/PPM (P5/P6) are read with numpy; every other format needs PIL.
PNM_EXTS = {".ppm", ".pgm"}

# Compact sensor-width database (mm) — the reference loads the OpenMVG
# sensor_width_camera_database.txt (sparseBuilder.h:20); a full file can be
# supplied via ``sensor_db_path``.
BUILTIN_SENSOR_DB = {
    "canon eos 5d mark iii": 36.0,
    "canon eos 5d mark ii": 35.8,
    "canon eos r5": 36.0,
    "nikon d850": 35.9,
    "nikon d750": 35.9,
    "sony ilce-7m3": 35.6,
    "sony ilce-7rm4": 35.7,
    "fujifilm x-t4": 23.5,
    "apple iphone 12": 5.76,
    "apple iphone 13": 7.01,
    "apple iphone 14 pro": 9.8,
    "google pixel 7": 6.81,
    "samsung sm-g998b": 6.4,
    "dji fc330": 6.24,
    "gopro hero9 black": 6.17,
}


@dataclasses.dataclass
class ImageRecord:
    path: str
    width: int
    height: int
    focal_px: float | None
    camera_model: str | None = None
    gps: tuple[float, float, float] | None = None


def load_sensor_db(path: str | None) -> dict[str, float]:
    db = dict(BUILTIN_SENSOR_DB)
    if path and Path(path).exists():
        for line in Path(path).read_text(errors="replace").splitlines():
            parts = line.strip().split(";")
            if len(parts) >= 2:
                try:
                    db[parts[0].strip().lower()] = float(parts[-1])
                except ValueError:
                    continue
    return db


def _exif_of(img) -> dict:
    try:
        exif = img.getexif()
        out = {k: v for k, v in exif.items()}
        # Merge the EXIF IFD (FocalLength etc. live there).
        try:
            out.update(dict(exif.get_ifd(0x8769)))
        except Exception:
            pass
        return out
    except Exception:
        return {}


def _gps_of(exif) -> tuple[float, float, float] | None:
    gps = exif.get(0x8825)
    try:
        if not gps:
            return None

        def to_deg(v):
            d, m, s = (float(x) for x in v)
            return d + m / 60.0 + s / 3600.0

        lat = to_deg(gps[2]) * (-1 if gps[1] == "S" else 1)
        lon = to_deg(gps[4]) * (-1 if gps[3] == "W" else 1)
        alt = float(gps.get(6, 0.0))
        return (lat, lon, alt)
    except Exception:
        return None


def _pil_image(what: str):
    """PIL's Image module, or an ImportError that names what needed it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{what} needs PIL (Pillow), which is not "
                          "installed; binary PGM/PPM (P5/P6) need nothing "
                          "beyond numpy") from e
    return Image


def _pnm_header(f):
    """Parse a binary PNM header -> (magic, width, height, maxval)."""
    fields: list[bytes] = []
    while len(fields) < 4:
        line = f.readline()
        if not line:
            raise ValueError(f"truncated PNM header in {f.name}")
        fields += line.split(b"#", 1)[0].split()
    magic = fields[0].decode()
    if magic not in ("P5", "P6"):
        raise ValueError(f"{f.name}: only binary PGM/PPM (P5/P6) are "
                         f"supported, not {magic}")
    return magic, int(fields[1]), int(fields[2]), int(fields[3])


def read_pnm(path: str | Path) -> np.ndarray:
    """Binary PGM (P5) -> (H, W), PPM (P6) -> (H, W, 3); uint8 for
    maxval < 256, big-endian 16-bit samples as uint16 otherwise."""
    with open(path, "rb") as f:
        magic, w, h, maxval = _pnm_header(f)
        dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        shape = (h, w) if magic == "P5" else (h, w, 3)
        data = np.frombuffer(f.read(int(np.prod(shape)) * dtype.itemsize),
                             dtype)
    if data.size != np.prod(shape):
        raise ValueError(f"{path}: truncated PNM data")
    return data.reshape(shape).astype(np.uint8 if maxval < 256 else np.uint16)


def write_pnm(path: str | Path, img: np.ndarray) -> None:
    """uint8 (H, W) -> binary PGM, (H, W, 3) -> binary PPM."""
    img = np.asarray(img, np.uint8)
    magic = "P5" if img.ndim == 2 else "P6"
    with open(path, "wb") as f:
        f.write(f"{magic}\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())


def write_png(path: str | Path, img: np.ndarray) -> None:
    """uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA -> PNG, encoded
    with zlib (no PIL)."""
    import struct
    import zlib

    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    color = {2: 0, 3: {3: 2, 4: 6}.get(img.shape[-1])}.get(img.ndim)
    if color is None:
        raise ValueError(f"cannot write an image of shape {img.shape} as PNG")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b""))


def _pnm_gray(path) -> np.ndarray:
    """Grayscale float32 in [0, 1] of a PGM/PPM (same luma weights as the
    native decoder)."""
    raw = read_pnm(path)
    a = raw.astype(np.float32) / (65535.0 if raw.dtype == np.uint16 else 255.0)
    if a.ndim == 3:
        a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    return a.astype(np.float32)


def list_images(directory: str | Path) -> list[Path]:
    """Sorted image listing (parity: list_files + computeIndexFromImageNames,
    sparseBuilder.cpp:258-312 — stable name order defines view indices)."""
    d = Path(directory)
    return sorted(p for p in d.iterdir() if p.suffix.lower() in IMAGE_EXTS)


def read_image_record(
    path: str | Path,
    sensor_db: dict[str, float] | None = None,
    focal_prior_px: float | None = None,
    default_fov_deg: float = 55.0,
) -> ImageRecord:
    sensor_db = sensor_db or BUILTIN_SENSOR_DB
    if Path(path).suffix.lower() in PNM_EXTS:
        with open(path, "rb") as f:
            _, w, h, _ = _pnm_header(f)
        exif = {}
    else:
        Image = _pil_image(f"reading {Path(path).suffix} images")
        with Image.open(path) as img:
            w, h = img.size
            exif = _exif_of(img)
    # Prefer the native C++ EXIF parser for JPEGs (tsfm_exif — the
    # counterpart of the reference's Exif_IO_EasyExif); PIL covers the rest.
    nat = None
    if Path(path).suffix.lower() in (".jpg", ".jpeg"):
        from . import native_ingest

        nat = native_ingest.exif_info(path) if native_ingest.available() else None
    if nat:
        make = nat.get("make", "").strip()
        model = nat.get("model", "").strip()
        cam = f"{make} {model}".strip() or None
        focal_mm = nat.get("focal_mm")
        gps = nat.get("gps")
    else:
        make = str(exif.get(271, "")).strip()
        model = str(exif.get(272, "")).strip()
        cam = f"{make} {model}".strip() or None
        focal_mm = exif.get(0x920A)  # FocalLength
        gps = _gps_of(exif)
    focal_px = None
    if focal_mm:
        try:
            focal_mm = float(focal_mm)
            key = (cam or "").lower()
            ccd = sensor_db.get(key) or sensor_db.get(model.lower())
            if ccd and focal_mm > 0:
                # .cpp:455: focal = max(w, h) * focal_mm / ccd_width_mm
                focal_px = max(w, h) * focal_mm / ccd
        except (TypeError, ValueError):
            focal_px = None
    if focal_px is None:
        focal_px = focal_prior_px
    if focal_px is None:
        focal_px = max(w, h) / (2.0 * np.tan(np.radians(default_fov_deg) / 2.0))
    return ImageRecord(
        path=str(path), width=w, height=h, focal_px=float(focal_px),
        camera_model=cam, gps=gps,
    )


def _native_batch(paths, want_gray: bool, want_rgb: bool):
    """Try the native C++ worker-pool decoder (native/src/ingest.cpp) for a
    uniform-size batch; None -> caller falls back to numpy / PIL."""
    from . import native_ingest

    if not paths or not native_ingest.available():
        return None
    info = native_ingest.image_info(paths[0])
    if info is None:
        return None
    w, h, _ = info
    res = native_ingest.load_batch(paths, w, h, gray=want_gray, rgb=want_rgb)
    if res is None:
        return None
    gray, rgb, status = res
    if not status.all():  # mixed sizes/undecodable -> fallback handles it
        return None
    return gray, rgb


def load_images_gray(paths, target_size: tuple[int, int] | None = None) -> np.ndarray:
    """Load images as (V, H, W) float32 grayscale in [0, 1].  All images must
    share one size (or are resized to target_size, which needs PIL).  Uses
    the native C++ threaded decoder when available; otherwise numpy for
    PGM/PPM and PIL for the other formats."""
    if target_size is None:
        res = _native_batch(list(paths), True, False)
        if res is not None:
            return res[0]
    out = []
    for p in paths:
        if target_size is None and Path(p).suffix.lower() in PNM_EXTS:
            out.append(_pnm_gray(p))
            continue
        Image = _pil_image(f"reading {Path(p).suffix} images"
                           if target_size is None else "resizing images")
        img = Image.open(p).convert("L")
        if target_size is not None:
            img = img.resize((target_size[1], target_size[0]))
        out.append(np.asarray(img, np.float32) / 255.0)
    shapes = {a.shape for a in out}
    if len(shapes) > 1:
        # Resize everything to the most common shape.
        from collections import Counter

        Image = _pil_image("resizing images of mixed sizes")
        target = Counter(a.shape for a in out).most_common(1)[0][0]
        out = [
            np.asarray(Image.fromarray((a * 255).astype(np.uint8)).resize((target[1], target[0])), np.float32) / 255.0
            if a.shape != target else a
            for a in out
        ]
    return np.stack(out)


def load_images_rgb(paths, target_size: tuple[int, int] | None = None) -> np.ndarray:
    if target_size is None:
        res = _native_batch(list(paths), False, True)
        if res is not None:
            return res[1]
    out = []
    for p in paths:
        if target_size is None and Path(p).suffix.lower() in PNM_EXTS:
            a = read_pnm(p)
            if a.dtype != np.uint8:
                a = (a >> 8).astype(np.uint8)
            out.append(np.repeat(a[..., None], 3, -1) if a.ndim == 2 else a)
            continue
        Image = _pil_image(f"reading {Path(p).suffix} images"
                           if target_size is None else "resizing images")
        img = Image.open(p).convert("RGB")
        if target_size is not None:
            img = img.resize((target_size[1], target_size[0]))
        out.append(np.asarray(img, np.uint8))
    return np.stack(out)

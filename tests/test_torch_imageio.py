"""The port's image IO (``utils/imageio.py``) against imageio, on the CPU.

The port decodes TIFF and PNG itself (numpy, struct, zlib), so its file
front doors run where no image library is installed. Every file here is
made from a seeded array: TIFFs built byte by byte in this file (strips,
tiles, both byte orders, the predictor, PackBits and Deflate, integer and
float samples, several pages), PNGs built byte by byte with each of the
five row filters, and files written by imageio and by Pillow. The port's
``read_image_array``/``read_stack_array`` must return the array the file
holds, bit for bit with the same dtype and shape, and the JAX package's
functions (imageio) must return the same. Two differences are the contract's: a multi-page TIFF
given to ``read_image_array`` raises (imageio through Pillow returns its
first page), and a 16-bit colour PNG keeps its 16 bits (Pillow cannot
read one). What the decoders do not read raises ``ValueError`` naming it
when imageio is not importable, and goes to imageio when it is.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

from fluorosequencingimageanalysis_tpu.utils import imageio as jax_imageio

from fluorosequencingimageanalysis_torch.utils import imageio as port_io

iio = pytest.importorskip("imageio.v2")
PIL_Image = pytest.importorskip("PIL.Image")

H, W = 37, 45  # neither divides by the strips or tiles below


def _known(dtype, shape=(H, W), seed=0):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return rng.normal(0, 1000, shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype,
                        endpoint=True)


def _block_image_libraries(monkeypatch, pil=False):
    for name in ("imageio", "imageio.v2") + (("PIL", "PIL.Image")
                                             if pil else ()):
        monkeypatch.setitem(sys.modules, name, None)


# -- TIFF built byte by byte ------------------------------------------------

def _packbits(data):
    """PackBits: a run of 4+ equal bytes as a repeat packet, the rest as
    literal packets of up to 128 bytes."""
    out, i = bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 128 and \
                data[i + run] == data[i]:
            run += 1
        if run >= 4:
            out += struct.pack("bB", 1 - run, data[i])
            i += run
        else:
            n = min(128, len(data) - i)
            out += struct.pack("b", n - 1) + data[i:i + n]
            i += n
    return bytes(out)


_ENCODE = {1: lambda b: b, 8: zlib.compress, 32946: zlib.compress,
           32773: _packbits}


def _tiff(pages, order="<", compression=1, predictor=1, rows=None,
          tile=None, photometric=None, extra_tags=()):
    """A classic TIFF whose IFDs come first and whose chunks follow."""
    heads, blobs = [], []
    for page in pages:
        page = np.asarray(page)
        spp = 1 if page.ndim == 2 else page.shape[2]
        arr = page.reshape(page.shape[0], page.shape[1], spp)
        h, w = arr.shape[:2]
        if tile is None:
            step = rows or h
            pieces = [arr[y:y + step] for y in range(0, h, step)]
        else:
            tl, tw = tile
            pad = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw, spp),
                           arr.dtype)
            pad[:h, :w] = arr
            pieces = [pad[y:y + tl, x:x + tw]
                      for y in range(0, pad.shape[0], tl)
                      for x in range(0, pad.shape[1], tw)]
        chunks = []
        for p in pieces:
            if predictor == 2:
                p = p.copy()
                p[:, 1:] = p[:, 1:] - p[:, :-1]   # wraps, as TIFF's does
            chunks.append(_ENCODE[compression](
                p.astype(p.dtype.newbyteorder(order)).tobytes()))
        fmt = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
        tags = [(256, 4, [w]), (257, 4, [h]),
                (258, 3, [arr.dtype.itemsize * 8] * spp),
                (259, 3, [compression]),
                (262, 3, [photometric or (2 if spp >= 3 else 1)]),
                (277, 3, [spp]), (317, 3, [predictor]),
                (339, 3, [fmt] * spp), *extra_tags]
        heads.append((tags, tile))
        blobs.append(chunks)
    # Layout: header, every IFD with its out-of-line values, the chunks.
    sizes = [2 + 12 * (len(t) + 3 + (tile is not None)) + 4 + 64 * 1024
             for t, _ in heads]
    ifd_at = [8 + sum(sizes[:i]) for i in range(len(heads))]
    data_at = 8 + sum(sizes)
    out = bytearray(struct.pack(order + "2sHI", b"II" if order == "<"
                                else b"MM", 42, ifd_at[0]))
    for i, ((tags, tile_), chunks) in enumerate(zip(heads, blobs)):
        offsets, counts = [], []
        for c in chunks:
            offsets.append(data_at)
            counts.append(len(c))
            data_at += len(c)
        if tile_ is None:
            tags = tags + [(273, 4, offsets), (278, 4, [rows or H * 100]),
                           (279, 4, counts)]
        else:
            tags = tags + [(322, 4, [tile_[1]]), (323, 4, [tile_[0]]),
                           (324, 4, offsets), (325, 4, counts)]
        tags.sort()
        table = bytearray(struct.pack(order + "H", len(tags)))
        extra = bytearray()
        extra_at = ifd_at[i] + 2 + 12 * len(tags) + 4
        for tag, typ, values in tags:
            char = {3: "H", 4: "I", 2: "s"}[typ]
            packed = (values if typ == 2 else
                      struct.pack(f"{order}{len(values)}{char}", *values))
            table += struct.pack(order + "HHI", tag, typ, len(packed) if
                                 typ == 2 else len(values))
            if len(packed) <= 4:
                table += packed.ljust(4, b"\0")
            else:
                table += struct.pack(order + "I", extra_at + len(extra))
                extra += packed
        nxt = ifd_at[i + 1] if i + 1 < len(heads) else 0
        table += struct.pack(order + "I", nxt) + extra
        out += table.ljust(sizes[i], b"\0")
    for chunks in blobs:
        for c in chunks:
            out += c
    return bytes(out)


HAND_TIFFS = {
    "u16_strips": lambda: ([_known("u2")], dict(rows=5)),
    "u16_big_endian": lambda: ([_known("u2", seed=1)],
                               dict(order=">", rows=16)),
    "u16_tiles_deflate": lambda: ([_known("u2", seed=2)],
                                  dict(tile=(16, 32), compression=8)),
    "u16_predictor_deflate": lambda: ([_known("u2", seed=3)],
                                      dict(compression=8, predictor=2,
                                           rows=8)),
    "i16_predictor_adobe_deflate_big_endian": lambda: (
        [_known("i2", seed=4)], dict(order=">", compression=32946,
                                     predictor=2, rows=7)),
    "i16_packbits": lambda: ([np.repeat(_known("i2", (H, 9), 5), 5,
                                        axis=1)], dict(compression=32773,
                                                       rows=10)),
    "f32_strips": lambda: ([_known("f4", seed=6)], dict(rows=4)),
    "f64_big_endian_tiles": lambda: ([_known("f8", seed=7)],
                                     dict(order=">", tile=(16, 16))),
    "u8_rgb_deflate": lambda: ([_known("u1", (H, W, 3), 8)],
                               dict(compression=8)),
    "u8_rgba_tiles_predictor": lambda: (
        [_known("u1", (H, W, 4), 9)], dict(tile=(32, 16), compression=8,
                                           predictor=2)),
    "u32_strips": lambda: ([_known("u4", seed=10)], dict(rows=9)),
    "i32_big_endian": lambda: ([_known("i4", seed=11)], dict(order=">")),
    "u8_packbits": lambda: ([_known("u1", seed=12) // 64 * 64],
                            dict(compression=32773)),
}


@pytest.mark.parametrize("name", sorted(HAND_TIFFS))
def test_hand_built_tiff_reads_as_its_array(name, tmp_path):
    pages, kw = HAND_TIFFS[name]()
    path = str(tmp_path / "f.tif")
    with open(path, "wb") as fh:
        fh.write(_tiff(pages, **kw))
    want = pages[0] if pages[0].ndim == 2 else pages[0][..., 0]
    got = port_io.read_image_array(path)
    assert got.dtype == want.dtype and got.dtype.isnative
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    stack = port_io.read_stack_array(path)
    assert stack.shape == (1,) + want.shape
    np.testing.assert_array_equal(stack[0], want)
    ref = jax_imageio.read_image_array(path)
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(got, ref)


def test_hand_built_multi_page_tiff_is_a_stack(tmp_path, monkeypatch):
    pages = [_known("u2", seed=s) for s in range(4)]
    path = str(tmp_path / "stack.tif")
    with open(path, "wb") as fh:
        fh.write(_tiff(pages, compression=8, rows=11))
    stack = port_io.read_stack_array(path)
    assert stack.shape == (4, H, W) and stack.dtype == np.uint16
    np.testing.assert_array_equal(stack, np.stack(pages))
    np.testing.assert_array_equal(stack,
                                  jax_imageio.read_stack_array(path))
    with pytest.raises(ValueError, match="4-page stack"):
        port_io.read_image_array(path)
    # An ImageJ stack whose images share one IFD is not read as one page.
    with open(path, "wb") as fh:
        fh.write(_tiff(pages[:1], extra_tags=[
            (270, 2, b"ImageJ=1.54f\nimages=4\nslices=4\n\0")]))
    _block_image_libraries(monkeypatch)
    with pytest.raises(ValueError, match="ImageJ stack of 4 images"):
        port_io.read_stack_array(path)


# -- PNG built byte by byte -------------------------------------------------

def _png(arr, color, filters=range(5), interlace=0, depth=None):
    """A PNG of ``arr`` whose rows take the filter types in turn."""
    arr = np.asarray(arr)
    depth = depth or arr.dtype.itemsize * 8
    h, w = arr.shape[:2]
    data = arr.astype(">u2") if depth == 16 else arr
    raw = data.reshape(h, -1).view(np.uint8).astype(np.int32)
    bpp = raw.shape[1] // w
    a = np.zeros_like(raw)
    a[:, bpp:] = raw[:, :-bpp]
    b = np.zeros_like(raw)
    b[1:] = raw[:-1]
    c = np.zeros_like(raw)
    c[1:, bpp:] = raw[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [0 * raw, a, b, (a + b) // 2, paeth]
    kinds = [list(filters)[y % len(list(filters))] for y in range(h)]
    rows = [bytes([k]) + ((raw[y] - preds[k][y]) % 256).astype(
        np.uint8).tobytes() for y, k in enumerate(kinds)]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload +
                struct.pack(">I", zlib.crc32(kind + payload)))

    body = zlib.compress(b"".join(rows))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace)) +
        chunk(b"tEXt", b"k\0v") + chunk(b"IDAT", body[:50]) +
        chunk(b"IDAT", body[50:]) + chunk(b"IEND", b""))


HAND_PNGS = {
    "gray8": (lambda: _known("u1"), 0),
    "gray16": (lambda: _known("u2", seed=1), 0),
    "gray_alpha8": (lambda: _known("u1", (H, W, 2), 2), 4),
    "gray_alpha16": (lambda: _known("u2", (H, W, 2), 3), 4),
    "rgb8": (lambda: _known("u1", (H, W, 3), 4), 2),
    "rgb16": (lambda: _known("u2", (H, W, 3), 5), 2),
    "rgba8": (lambda: _known("u1", (H, W, 4), 6), 6),
    "rgba16": (lambda: _known("u2", (H, W, 4), 7), 6),
}


@pytest.mark.parametrize("name", sorted(HAND_PNGS))
def test_hand_built_png_with_every_filter_reads_as_its_array(name,
                                                             tmp_path):
    make, color = HAND_PNGS[name]
    arr = make()
    path = str(tmp_path / "f.png")
    with open(path, "wb") as fh:
        fh.write(_png(arr, color))
    want = arr if arr.ndim == 2 else arr[..., 0]
    got = port_io.read_image_array(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port_io.read_stack_array(path)[0], want)
    if arr.dtype == np.uint16 and arr.ndim == 3:
        return      # Pillow cannot read 16-bit colour
    ref = jax_imageio.read_image_array(path)
    assert ref.dtype == got.dtype and ref.shape == got.shape
    np.testing.assert_array_equal(got, ref)


# -- files written by imageio and Pillow ------------------------------------

def _write_pillow(path, arr, **kw):
    PIL_Image.fromarray(arr).save(path, **kw)


LIBRARY_FILES = {
    "imageio_png_u8": ("png", lambda p: iio.imwrite(p, _known("u1"))),
    "imageio_png_u16": ("png", lambda p: iio.imwrite(p, _known("u2"))),
    "pillow_png_rgb": ("png", lambda p: _write_pillow(
        p, _known("u1", (H, W, 3)))),
    "pillow_png_rgba": ("png", lambda p: _write_pillow(
        p, _known("u1", (H, W, 4)))),
    "pillow_png_la": ("png", lambda p: PIL_Image.fromarray(
        _known("u1", (H, W, 2)), "LA").save(p)),
    "pillow_png_512_u16": ("png", lambda p: _write_pillow(
        p, _known("u2", (512, 512)) // 256 * 7)),
    "pillow_tif_none": ("tif", lambda p: _write_pillow(p, _known("u2"))),
    "pillow_tif_lzw": ("tif", lambda p: _write_pillow(
        p, _known("u2"), compression="tiff_lzw")),
    "pillow_tif_lzw_u8_rgb": ("tif", lambda p: _write_pillow(
        p, _known("u1", (H, W, 3)), compression="tiff_lzw")),
    "pillow_tif_lzw_smooth": ("tif", lambda p: _write_pillow(
        p, np.add.outer(np.arange(300), np.arange(200)).astype(np.uint16),
        compression="tiff_lzw")),
    "pillow_tif_adobe_deflate": ("tif", lambda p: _write_pillow(
        p, _known("u2"), compression="tiff_adobe_deflate")),
    "pillow_tif_deflate": ("tif", lambda p: _write_pillow(
        p, _known("u2"), compression="tiff_deflate")),
    "pillow_tif_packbits": ("tif", lambda p: _write_pillow(
        p, _known("u1") // 32, compression="packbits")),
    "imageio_tif_u8": ("tif", lambda p: iio.imwrite(p, _known("u1"))),
    "imageio_tif_i16": ("tif", lambda p: iio.imwrite(p, _known("i2"))),
    "imageio_tif_u32": ("tif", lambda p: iio.imwrite(p, _known("u4"))),
    "imageio_tif_i32": ("tif", lambda p: iio.imwrite(p, _known("i4"))),
    "imageio_tif_f32": ("tif", lambda p: iio.imwrite(p, _known("f4"))),
    "imageio_tif_f64": ("tif", lambda p: iio.imwrite(p, _known("f8"))),
}


@pytest.mark.parametrize("name", sorted(LIBRARY_FILES))
def test_library_written_file_reads_as_imageio_reads_it(name, tmp_path):
    ext, write = LIBRARY_FILES[name]
    path = str(tmp_path / f"f.{ext}")
    write(path)
    ref = jax_imageio.read_image_array(path)
    got = port_io.read_image_array(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(port_io.read_stack_array(path),
                                  jax_imageio.read_stack_array(path))


def test_imageio_multi_page_tiff_is_imageios_stack(tmp_path):
    pages = [_known("u2", seed=s) for s in range(5)]
    path = str(tmp_path / "m.tif")
    iio.mimwrite(path, pages)
    got = port_io.read_stack_array(path)
    ref = jax_imageio.read_stack_array(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (5, H, W)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.stack(pages))


# -- the port's writers, read back by imageio -------------------------------

WRITER_CASES = {
    "none": dict(), "packbits": dict(compression="packbits"),
    "deflate": dict(compression="deflate"), "lzw": dict(compression="lzw"),
    "deflate_predictor": dict(compression="deflate", predictor=True),
    "lzw_predictor": dict(compression="lzw", predictor=True),
    "big_endian": dict(byteorder=">"),
    "tiled": dict(tile=(16, 32), compression="deflate"),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_write_tiff_is_read_back_by_imageio_and_the_port(case, tmp_path):
    # A smooth field and noise: LZW's table fills and clears on both.
    field = np.add.outer(np.arange(300), 3 * np.arange(260)).astype(
        np.uint16)
    field[::3] += _known("u2", (100, 260), 4) // 1024
    path = str(tmp_path / "w.tif")
    port_io.write_tiff(path, field, **WRITER_CASES[case])
    ref = jax_imageio.read_image_array(path)
    got = port_io.read_image_array(path)
    assert got.dtype == ref.dtype == np.uint16
    np.testing.assert_array_equal(ref, field)
    np.testing.assert_array_equal(got, field)


def test_write_tiff_pages_and_write_png_are_read_back(tmp_path):
    pages = np.stack([_known("i2", seed=s) for s in range(3)])
    path = str(tmp_path / "p.tif")
    port_io.write_tiff(path, pages, compression="lzw", predictor=True)
    np.testing.assert_array_equal(port_io.read_stack_array(path), pages)
    np.testing.assert_array_equal(jax_imageio.read_stack_array(path), pages)
    for dtype in ("u1", "u2"):
        arr = _known(dtype, seed=8)
        png = str(tmp_path / f"{dtype}.png")
        port_io.write_png(png, arr)
        ref = jax_imageio.read_image_array(png)
        assert ref.dtype == arr.dtype
        np.testing.assert_array_equal(ref, arr)
        np.testing.assert_array_equal(port_io.read_image_array(png), arr)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        port_io.write_png(png, _known("f4"))


# -- the path conventions ---------------------------------------------------

def test_read_image_prefers_the_sibling_png(tmp_path):
    tif, sibling = str(tmp_path / "a.tif"), str(tmp_path / "a.tif.png")
    port_io.write_tiff(tif, _known("u2", seed=1))
    path, arr = port_io.read_image(tif)
    assert path == tif
    np.testing.assert_array_equal(arr, _known("u2", seed=1))
    port_io.write_png(sibling, _known("u2", seed=2))
    for mod in (port_io, jax_imageio):
        path, arr = mod.read_image(tif)
        assert path == sibling
        np.testing.assert_array_equal(arr, _known("u2", seed=2))
    path, arr = port_io.read_image(sibling)
    assert path == sibling


def test_convert_image_round_trip(tmp_path, monkeypatch):
    _block_image_libraries(monkeypatch, pil=True)
    for dtype in ("u1", "u2"):
        src = str(tmp_path / f"{dtype}.tif")
        port_io.write_tiff(src, _known(dtype, seed=3), compression="lzw")
        out = port_io.convert_image(src)
        assert out == src + ".png"
        np.testing.assert_array_equal(port_io.read_image_array(out),
                                      _known(dtype, seed=3))
        named = str(tmp_path / f"named_{dtype}.png")
        assert port_io.convert_image(src, named) == named
        np.testing.assert_array_equal(port_io.read_image(src)[1],
                                      _known(dtype, seed=3))
    assert port_io.convert_image(str(tmp_path / "missing.tif")) is None
    monkeypatch.undo()
    np.testing.assert_array_equal(jax_imageio.read_image_array(out),
                                  _known("u2", seed=3))


# -- what the decoders do not read ------------------------------------------

def _unsupported_files(tmp_path):
    arr = _known("u1", (40, 48), seed=5)
    out = {}
    p = str(tmp_path / "big.tif")
    with open(p, "wb") as fh:
        fh.write(b"II+\0\x08\0\0\0" + bytes(64))
    out["BigTIFF"] = p
    p = str(tmp_path / "jpegtag.tif")
    with open(p, "wb") as fh:
        fh.write(_tiff([arr]).replace(
            struct.pack("<HHIHH", 259, 3, 1, 1, 0),
            struct.pack("<HHIHH", 259, 3, 1, 7, 0)))
    out["TIFF compression 7"] = p
    p = str(tmp_path / "float_predictor.tif")
    with open(p, "wb") as fh:
        fh.write(_tiff([_known("f4")], predictor=3, compression=8))
    out["TIFF predictor 3"] = p
    p = str(tmp_path / "white.tif")
    with open(p, "wb") as fh:
        fh.write(_tiff([arr], photometric=5))
    out["photometric interpretation 5"] = p
    p = str(tmp_path / "adam7.png")
    with open(p, "wb") as fh:
        fh.write(_png(arr, 0, interlace=1))
    out["interlaced"] = p
    p = str(tmp_path / "palette.png")
    PIL_Image.fromarray(arr // 16).convert("P").save(p)
    out["PNG colour type 3"] = p
    p = str(tmp_path / "photo.jpg")
    PIL_Image.fromarray(arr).save(p, quality=90)
    out["JPEG"] = p
    p = str(tmp_path / "bits.png")
    with open(p, "wb") as fh:
        fh.write(_png(arr // 128, 0, depth=1, filters=[0]))
    out["1-bit samples"] = p
    return out


def test_unsupported_files_raise_without_imageio(tmp_path, monkeypatch):
    files = _unsupported_files(tmp_path)
    _block_image_libraries(monkeypatch)
    for what, path in files.items():
        for read in (port_io.read_image_array, port_io.read_stack_array):
            with pytest.raises(ValueError) as err:
                read(path)
            assert what in str(err.value) and \
                "needs imageio" in str(err.value), (what, str(err.value))


def test_unsupported_files_go_to_imageio_where_it_is_installed(tmp_path):
    files = _unsupported_files(tmp_path)
    for what in ("JPEG", "PNG colour type 3"):
        got = port_io.read_image_array(files[what])
        ref = jax_imageio.read_image_array(files[what])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(port_io.read_stack_array(files[what]),
                                      jax_imageio.read_stack_array(
                                          files[what]))


def test_corrupt_files_raise_and_never_return_an_array(tmp_path,
                                                       monkeypatch):
    _block_image_libraries(monkeypatch)
    good = _tiff([_known("u2")], rows=5)
    # The only IFD (at 8) names itself as the next one.
    loop = bytearray(good)
    (count,) = struct.unpack("<H", loop[8:10])
    loop[10 + 12 * count:14 + 12 * count] = struct.pack("<I", 8)
    crc = bytearray(_png(_known("u1"), 0))
    crc[40] ^= 0xFF
    cases = {"short.tif": good[:len(good) - 100], "loop.tif": loop,
             "crc.png": crc}
    for name, data in cases.items():
        path = str(tmp_path / name)
        with open(path, "wb") as fh:
            fh.write(bytes(data))
        with pytest.raises(ValueError):
            port_io.read_stack_array(path)


def test_tiff_and_png_paths_import_no_image_library(tmp_path, monkeypatch):
    files = []
    for i, name in enumerate(sorted(HAND_TIFFS)):
        p = str(tmp_path / f"{i}.tif")
        pages, kw = HAND_TIFFS[name]()
        with open(p, "wb") as fh:
            fh.write(_tiff(pages, **kw))
        files.append(p)
    for name, (make, color) in HAND_PNGS.items():
        p = str(tmp_path / f"{name}.png")
        with open(p, "wb") as fh:
            fh.write(_png(make(), color))
        files.append(p)
    _block_image_libraries(monkeypatch, pil=True)
    for p in files:
        assert port_io.read_image_array(p).ndim == 2
        assert port_io.read_stack_array(p).ndim == 3
    assert port_io.convert_image(files[0], str(tmp_path / "c.png")) is None
    assert port_io.convert_image(files[-1], str(tmp_path / "c.png"))

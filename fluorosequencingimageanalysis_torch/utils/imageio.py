"""Host-side image IO.

The reference shells out to ImageMagick `convert` to turn arbitrary formats
into PNG before reading (pflib.py:55-90, 714-746). We read TIFF and PNG
with decoders of our own (numpy, ``struct`` and ``zlib``), so every file
front door runs where no image library is installed, while keeping the
reference's path conventions (a non-PNG target with an existing sibling
``<path>.png`` uses the sibling).

The arrays are those the JAX package's copy (fluorosequencingimageanalysis
_tpu/utils/imageio.py) returns through imageio: the same values, dtype and
shape, channel-last RGB(A) reduced to its first channel, and a multi-page
stack refused by ``read_image_array``. Arrays come back in the machine's
byte order, and a 16-bit colour PNG keeps its 16 bits (Pillow, under
imageio, cannot read one).

What the decoders read:

* TIFF (classic, either byte order): every page of the IFD chain; strips
  or tiles; 8-64-bit unsigned and signed integer or 32/64-bit float
  samples, 1-4 samples a pixel, interleaved; no compression, PackBits,
  Deflate or LZW, with the horizontal predictor under Deflate and LZW.
* PNG: grayscale and RGB(A) (with or without alpha), 8 and 16 bits, not
  interlaced.

Anything else (BigTIFF, JPEG, palette images, other compressions, an
interlaced PNG, ...) goes to imageio where it is installed; where it is
not, the read raises ``ValueError`` naming what it met.

``write_png`` and ``write_tiff`` are the writers of the same formats
(``convert_image`` writes its PNG with the first); tests and the smoke run
write their inputs with them.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_TIFF_ORDER = {b"II*\0": "<", b"MM\0*": ">"}
_BIGTIFF = (b"II+\0", b"MM\0+")
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JPEG_MAGIC = b"\xff\xd8\xff"


class _Unsupported(Exception):
    """A file our decoders do not read; the message names what it is."""


def _imageio_for(image_path, what):
    """imageio, to read what our decoders do not; ValueError without it."""
    try:
        import imageio.v2 as iio
    except ImportError:
        raise ValueError(
            f"{image_path}: {what} is not read by the port's own decoders; "
            "reading it needs imageio, which is not installed") from None
    return iio


def _collapse_channels(arr):
    """Channel-last RGB(A) sanity-check images -> grayscale (first
    channel)."""
    if arr.ndim == 3 and arr.shape[-1] <= 4:
        return arr[..., 0]
    return arr


def read_image_array(image_path: str) -> np.ndarray:
    try:
        pages = _read_pages(image_path)
    except _Unsupported as exc:
        iio = _imageio_for(image_path, str(exc))
        return _read_image_with_imageio(iio, image_path)
    if len(pages) > 1:
        raise ValueError(
            f"{image_path} is a {len(pages)}-page stack, not a single "
            "image; read it with read_stack_array (or pass per-frame "
            "files).")
    return _collapse_channels(pages[0])


def _read_image_with_imageio(iio, image_path):
    arr = np.asarray(iio.imread(image_path))
    if arr.ndim == 3:
        if arr.shape[-1] <= 4:
            arr = arr[..., 0]
        elif arr.shape[0] == 1:
            # Single-page TIFF read back as a (1, H, W) stack.
            arr = arr[0]
        else:
            # Frame-first (Z, H, W) multi-page stack: arr[..., 0] would
            # silently slice the first COLUMN of every page.
            raise ValueError(
                f"{image_path} is a {arr.shape[0]}-page stack, not a "
                "single image; read it with read_stack_array (or pass "
                "per-frame files).")
    return arr


def read_stack_array(image_path: str) -> np.ndarray:
    """Read a multi-page image as a (frames, H, W) stack.

    Single-page inputs come back with frames == 1, so movie/z-stack CLIs
    can accept either one multi-page TIFF or a list of per-frame files.
    """
    try:
        pages = _read_pages(image_path)
    except _Unsupported as exc:
        iio = _imageio_for(image_path, str(exc))
        try:
            pages = [np.asarray(p) for p in iio.mimread(image_path,
                                                        memtest=False)]
        except Exception:
            pages = [np.asarray(iio.imread(image_path))]
    frames = []
    for page in pages:
        page = _collapse_channels(page)
        if page.ndim != 2:
            raise ValueError(
                f"{image_path}: page of shape {page.shape} is not a "
                "2-D grayscale frame.")
        frames.append(page)
    return np.stack(frames)


def read_image(image_path: str):
    """(converted_path, image) — parity with pflib.read_image (pflib.py:714).

    If the target is not a PNG and ``<path>.png`` exists, the sibling PNG is
    read (the reference's convert-once convention). Otherwise the file is
    read directly — no conversion subprocess is needed.
    """
    converted_path = image_path = os.path.abspath(image_path)
    if not image_path.endswith(".png") and os.path.exists(image_path + ".png"):
        converted_path = image_path + ".png"
    return converted_path, read_image_array(converted_path)


def convert_image(input_path, output_path=None, output_format="png",
                  convert_command=None):
    """Convert an image by decoding + re-encoding in-process.

    API parity with pflib.convert_image (pflib.py:55-90); the
    convert_command argument is accepted for compatibility and ignored
    (no subprocess is spawned). 8- and 16-bit grayscale PNG is written by
    ``write_png``; any other target goes to imageio.
    """
    if output_path is None:
        output_path = ".".join((input_path, output_format))
    try:
        arr = read_image_array(input_path)
        if (output_path.lower().endswith(".png") and arr.ndim == 2
                and arr.dtype in (np.uint8, np.uint16)):
            write_png(output_path, arr)
        else:
            _imageio_for(input_path, f"writing {output_path}").imwrite(
                output_path, arr)
    except Exception:
        import logging
        logging.getLogger(__name__).exception("convert_image failed")
        return None
    return output_path


def _read_pages(image_path):
    """Every page of a TIFF or PNG as an array ((H, W) or (H, W, S)), or
    _Unsupported naming what the file is."""
    with open(image_path, "rb") as fh:
        head = fh.read(8)
        if head[:4] in _TIFF_ORDER:
            return _tiff_pages(fh, image_path, _TIFF_ORDER[head[:4]], head)
        if head == _PNG_MAGIC:
            return [_png_image(fh, image_path)]
    if head[:4] in _BIGTIFF:
        raise _Unsupported("BigTIFF")
    if head[:3] == _JPEG_MAGIC:
        raise _Unsupported("JPEG")
    raise _Unsupported("an image format other than TIFF and PNG")


# -- TIFF ------------------------------------------------------------------

# The field types the tags below take (BYTE, ASCII, SHORT, LONG): numpy
# dtype, bytes a value.
_TIFF_TYPES = {1: ("u1", 1), 2: ("S1", 1), 3: ("u2", 2), 4: ("u4", 4)}
# Tags read: width, length, bits, compression, photometric, description,
# strip offsets, samples a pixel, rows a strip, strip byte counts, fill
# order, planar configuration, predictor, tile width, tile length, tile
# offsets, tile byte counts, sample format.
_TAGS = {256, 257, 258, 259, 262, 270, 273, 277, 278, 279, 266, 284, 317,
         322, 323, 324, 325, 339}
_COMPRESSION = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                32773: "PackBits"}
_SAMPLE_KIND = {1: "u", 2: "i", 3: "f"}


def _tiff_pages(fh, path, order, head):
    (offset,) = struct.unpack(order + "I", head[4:8])
    ifds, seen = [], set()
    while offset:
        if offset in seen:
            raise ValueError(f"{path}: the TIFF's IFD chain loops")
        seen.add(offset)
        ifd, offset = _tiff_ifd(fh, path, order, offset)
        ifds.append(ifd)
    if not ifds:
        raise ValueError(f"{path}: a TIFF without pages")
    described = _imagej_images(ifds[0].get(270))
    if described > len(ifds):
        raise _Unsupported(f"an ImageJ stack of {described} images in "
                           f"{len(ifds)} IFDs")
    return [_tiff_page(fh, path, order, ifd) for ifd in ifds]


def _tiff_ifd(fh, path, order, offset):
    """The tags we read of the IFD at ``offset`` and the next IFD's
    offset."""
    fh.seek(offset)
    raw = fh.read(2)
    if len(raw) < 2:
        raise ValueError(f"{path}: truncated TIFF (IFD at {offset})")
    (count,) = struct.unpack(order + "H", raw)
    raw = fh.read(12 * count + 4)
    if len(raw) < 12 * count + 4:
        raise ValueError(f"{path}: truncated TIFF (IFD at {offset})")
    tags = {}
    for i in range(count):
        tag, typ, n = struct.unpack(order + "HHI", raw[12 * i:12 * i + 8])
        if tag not in _TAGS:
            continue
        if typ not in _TIFF_TYPES:
            raise _Unsupported(f"TIFF tag {tag} of field type {typ}")
        char, size = _TIFF_TYPES[typ]
        field = raw[12 * i + 8:12 * i + 12]
        if size * n <= 4:
            data = field[:size * n]
        else:
            (at,) = struct.unpack(order + "I", field)
            fh.seek(at)
            data = fh.read(size * n)
            if len(data) < size * n:
                raise ValueError(f"{path}: truncated TIFF (tag {tag})")
        if typ == 2:
            tags[tag] = data.split(b"\0", 1)[0].decode("latin-1")
        else:
            tags[tag] = [int(v) for v in np.frombuffer(data, order + char)]
    (nxt,) = struct.unpack(order + "I", raw[12 * count:])
    return tags, nxt


def _imagej_images(description):
    """The image count an ImageJ description names (1 where it names
    none): ImageJ's large stacks keep every image behind one IFD."""
    if not description or not description.startswith("ImageJ="):
        return 1
    for line in description.splitlines():
        if line.startswith("images="):
            return int(line.split("=", 1)[1])
    return 1


def _tiff_page(fh, path, order, tags):
    def one(tag, default=None):
        if tag not in tags:
            if default is None:
                raise ValueError(f"{path}: TIFF page without tag {tag}")
            return default
        return tags[tag][0]

    width, height = one(256), one(257)
    spp = one(277, 1)
    bits = set(tags.get(258, [1]))
    kinds = set(tags.get(339, [1]))
    compression = one(259, 1)
    photometric = one(262, -1)
    predictor = one(317, 1)
    if compression not in _COMPRESSION:
        raise _Unsupported(f"TIFF compression {compression}")
    if len(bits) != 1 or len(kinds) != 1:
        raise _Unsupported("a TIFF whose samples differ in type")
    (bits,), (kind,) = bits, kinds
    if kind not in _SAMPLE_KIND or bits not in (8, 16, 32, 64) or (
            kind == 3 and bits < 32):
        raise _Unsupported(f"TIFF samples of {bits} bits, format {kind}")
    if not 1 <= spp <= 4:
        raise _Unsupported(f"TIFF pixels of {spp} samples")
    if photometric not in (1, 2):
        raise _Unsupported(f"TIFF photometric interpretation {photometric}")
    if spp > 1 and one(284, 1) != 1:
        raise _Unsupported("a TIFF with separate sample planes")
    if one(266, 1) != 1:
        raise _Unsupported("a TIFF with fill order 2")
    if predictor not in (1, 2) or (predictor == 2 and (
            kind == 3 or compression not in (5, 8, 32946))):
        raise _Unsupported(f"TIFF predictor {predictor} under "
                           f"{_COMPRESSION[compression]} compression")
    dtype = np.dtype(f"{order}{_SAMPLE_KIND[kind]}{bits // 8}")
    native = dtype.newbyteorder("=")
    out = np.empty((height, width, spp), native)
    row_bytes = width * spp * dtype.itemsize

    if 322 in tags:  # tiles
        tw, tl = one(322), one(323)
        offsets, counts = tags[324], tags.get(325)
        across = -(-width // tw)
        tile_bytes = tl * tw * spp * dtype.itemsize
        for i, at in enumerate(offsets):
            y, x = (i // across) * tl, (i % across) * tw
            if y >= height:
                break
            n = tile_bytes if counts is None else counts[i]
            chunk = _tiff_chunk(fh, path, at, n, tile_bytes, compression,
                                dtype, predictor, (tl, tw, spp))
            h, w = min(tl, height - y), min(tw, width - x)
            out[y:y + h, x:x + w] = chunk[:h, :w]
    else:
        rows = min(one(278, height), height)
        offsets = tags[273]
        counts = tags.get(279)
        spans = [(i * rows, min(height, (i + 1) * rows))
                 for i in range(len(offsets))]
        if compression == 1:
            _tiff_raw_strips(fh, path, out, row_bytes, offsets, counts,
                             spans, dtype)
        else:
            for (y0, y1), at, n in zip(spans, offsets, counts):
                if y0 >= height:
                    break
                out[y0:y1] = _tiff_chunk(
                    fh, path, at, n, (y1 - y0) * row_bytes, compression,
                    dtype, predictor, (y1 - y0, width, spp))
    return out[..., 0] if spp == 1 else out


def _tiff_raw_strips(fh, path, out, row_bytes, offsets, counts, spans,
                     dtype):
    """Uncompressed strips straight into ``out``: one read for each run of
    strips that follow each other in the file."""
    buf = out.view(np.uint8).reshape(-1)
    runs = []  # [file offset, buffer offset, bytes]
    for (y0, y1), at in zip(spans, offsets):
        need = (y1 - y0) * row_bytes
        if need <= 0:
            continue
        if runs and runs[-1][0] + runs[-1][2] == at and \
                runs[-1][1] + runs[-1][2] == y0 * row_bytes:
            runs[-1][2] += need
        else:
            runs.append([at, y0 * row_bytes, need])
    if counts is not None and any(
            c < (y1 - y0) * row_bytes for c, (y0, y1) in zip(counts, spans)
            if y1 > y0):
        raise ValueError(f"{path}: a TIFF strip is shorter than its rows")
    view = memoryview(buf)
    for at, pos, n in runs:
        fh.seek(at)
        if fh.readinto(view[pos:pos + n]) != n:
            raise ValueError(f"{path}: truncated TIFF (strip at {at})")
    if not dtype.isnative:
        out.byteswap(inplace=True)


def _tiff_chunk(fh, path, at, n, need, compression, dtype, predictor,
                shape):
    """One strip or tile, decoded to ``shape`` in the machine's order."""
    fh.seek(at)
    data = fh.read(n)
    if len(data) < n:
        raise ValueError(f"{path}: truncated TIFF (chunk at {at})")
    if compression in (8, 32946):
        data = zlib.decompress(data)
    elif compression == 5:
        data = _lzw_decode(data, path)
    elif compression == 32773:
        data = _packbits_decode(data, need)
    if len(data) < need:
        raise ValueError(f"{path}: a TIFF chunk decodes to {len(data)} "
                         f"bytes, {need} wanted")
    chunk = np.frombuffer(data[:need], dtype).reshape(shape)
    chunk = chunk.astype(dtype.newbyteorder("="))
    if predictor == 2:
        chunk = np.cumsum(chunk, axis=1, dtype=chunk.dtype)
    return chunk


def _packbits_decode(data, need):
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < need:
        h = data[i]
        i += 1
        if h < 128:
            out += data[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += data[i:i + 1] * (257 - h)
            i += 1
    return bytes(out)


def _lzw_decode(data, path):
    """TIFF's LZW: codes of 9-12 bits, most significant bit first, code
    256 clears the table, 257 ends, and the width grows one code early."""
    if data[:2] == b"\x00\x01":
        raise _Unsupported("old-style (pre-6.0) TIFF LZW")
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    nbits, buf, held, prev = 9, 0, 0, None
    for byte in data:
        buf = (buf << 8) | byte
        held += 8
        while held >= nbits:
            held -= nbits
            code = buf >> held
            buf &= (1 << held) - 1
            if code == 256:
                del table[258:]
                nbits, prev = 9, None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                entry = table[code]
            else:
                if code < len(table):
                    entry = table[code]
                elif code == len(table):
                    entry = prev + prev[:1]
                else:
                    raise ValueError(f"{path}: corrupt LZW data")
                if len(table) < 4096:
                    table.append(prev + entry[:1])
                    if len(table) >= (1 << nbits) - 1 and nbits < 12:
                        nbits += 1
            out += entry
            prev = entry
    return bytes(out)


def _packbits_encode(data):
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _lzw_encode(data):
    out, acc, held = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, held
        acc = (acc << nbits) | code
        held += nbits
        while held >= 8:
            held -= 8
            out.append((acc >> held) & 0xFF)
        acc &= (1 << held) - 1

    table = {bytes([i]): i for i in range(256)}
    nbits, nxt, word = 9, 258, b""
    put(256, nbits)
    for byte in data:
        grown = word + bytes([byte])
        if grown in table:
            word = grown
            continue
        put(table[word], nbits)
        table[grown] = nxt
        nxt += 1
        if nxt == 4094:
            put(256, nbits)
            table = {bytes([i]): i for i in range(256)}
            nbits, nxt = 9, 258
        elif nxt > (1 << nbits) - 1:
            nbits += 1
        word = bytes([byte])
    if word:
        put(table[word], nbits)
        nxt += 1
        if nxt > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257, nbits)
    if held:
        out.append((acc << (8 - held)) & 0xFF)
    return bytes(out)


_TIFF_WRITE_COMPRESSION = {"none": 1, "lzw": 5, "deflate": 8,
                           "packbits": 32773}


def write_tiff(path, pages, compression="none", predictor=False,
               byteorder="<", tile=None):
    """Write 2-D arrays as the pages of a classic TIFF: one strip a page,
    or ``tile`` = (length, width) tiles; ``compression`` of none,
    packbits, deflate and lzw; the horizontal predictor with deflate and
    lzw."""
    code = _TIFF_WRITE_COMPRESSION[compression]
    if isinstance(pages, np.ndarray) and pages.ndim == 2:
        pages = [pages]
    blobs, ifds = [], []
    pos = 8
    for page in pages:
        page = np.asarray(page)
        h, w = page.shape
        arr = page.astype(page.dtype.newbyteorder(byteorder))
        if tile is None:
            pieces = [arr]
        else:
            tl, tw = tile
            padded = np.zeros((-(-h // tl) * tl, -(-w // tw) * tw),
                              arr.dtype)
            padded[:h, :w] = arr
            pieces = [padded[y:y + tl, x:x + tw]
                      for y in range(0, padded.shape[0], tl)
                      for x in range(0, padded.shape[1], tw)]
        offsets, counts = [], []
        for piece in pieces:
            if predictor:
                piece = np.diff(piece.astype(page.dtype), axis=1,
                                prepend=0).astype(arr.dtype)
            raw = np.ascontiguousarray(piece).tobytes()
            if code == 8:
                raw = zlib.compress(raw, 6)
            elif code == 5:
                raw = _lzw_encode(raw)
            elif code == 32773:
                raw = _packbits_encode(raw)
            offsets.append(pos)
            counts.append(len(raw))
            blobs.append(raw)
            pos += len(raw)
        kind = {"u": 1, "i": 2, "f": 3}[page.dtype.kind]
        entries = [(256, 4, [w]), (257, 4, [h]),
                   (258, 3, [8 * page.dtype.itemsize]), (259, 3, [code]),
                   (262, 3, [1]), (277, 3, [1]), (284, 3, [1]),
                   (339, 3, [kind])]
        if predictor:
            entries.append((317, 3, [2]))
        if tile is None:
            entries += [(273, 4, offsets), (278, 4, [h]),
                        (279, 4, counts)]
        else:
            entries += [(322, 4, [tile[1]]), (323, 4, [tile[0]]),
                        (324, 4, offsets), (325, 4, counts)]
        ifds.append(sorted(entries))
    out = bytearray(b"II*\0" if byteorder == "<" else b"MM\0*")
    out += struct.pack(byteorder + "I", pos if ifds else 0)
    for blob in blobs:
        out += blob
    for i, entries in enumerate(ifds):
        start = len(out)
        extra_at = start + 2 + 12 * len(entries) + 4
        table, extra = bytearray(), bytearray()
        for tag, typ, values in entries:
            char = "I" if typ == 4 else "H"
            packed = struct.pack(f"{byteorder}{len(values)}{char}", *values)
            table += struct.pack(byteorder + "HHI", tag, typ, len(values))
            if len(packed) <= 4:
                table += packed.ljust(4, b"\0")
            else:
                table += struct.pack(byteorder + "I",
                                     extra_at + len(extra))
                extra += packed
        nxt = extra_at + len(extra) if i + 1 < len(ifds) else 0
        out += struct.pack(byteorder + "H", len(entries)) + table
        out += struct.pack(byteorder + "I", nxt) + extra
    with open(path, "wb") as fh:
        fh.write(out)


# -- PNG -------------------------------------------------------------------

_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_image(fh, path):
    chunks, header = [], None
    while True:
        raw = fh.read(8)
        if len(raw) < 8:
            raise ValueError(f"{path}: truncated PNG")
        n, kind = struct.unpack(">I4s", raw)
        data, crc = fh.read(n), fh.read(4)
        if len(data) < n or len(crc) < 4 or \
                zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            chunks.append(data)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: a PNG without a header")
    width, height, depth, color, _, _, interlace = header
    if color not in _PNG_CHANNELS:
        raise _Unsupported(f"PNG colour type {color}")
    if depth not in (8, 16):
        raise _Unsupported(f"a PNG of {depth}-bit samples")
    if interlace:
        raise _Unsupported("an interlaced (Adam7) PNG")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(chunks)), np.uint8)
    if raw.size < height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    data = _png_unfilter(rows[:, 0], rows[:, 1:], bpp, path)
    arr = data.view(">u2").astype(np.uint16) if depth == 16 else data
    arr = arr.reshape(height, width, channels)
    return arr[..., 0] if channels == 1 else arr


def _png_unfilter(filters, data, bpp, path):
    """Undo PNG's per-row filters. A byte depends on its left, upper and
    upper-left neighbours, so the pixels of one anti-diagonal are
    independent: the rows are undone together, one diagonal a step. On a
    grid padded by a zero row and column, flattened, a diagonal is a slice
    of stride ``width``."""
    if not filters.any():
        return np.ascontiguousarray(data)
    if filters.max() > 4:
        raise ValueError(f"{path}: PNG filter type {filters.max()}")
    height, stride = data.shape
    width = stride // bpp
    row = width + 1
    raw = np.zeros((height + 1, row, bpp), np.int16)
    raw[1:, 1:] = data.reshape(height, width, bpp)
    kind = np.zeros((height + 1, row, 1), np.int16)
    kind[1:, 1:] = filters[:, None, None]
    raw, kind = raw.reshape(-1, bpp), kind.reshape(-1, 1)
    out = np.zeros_like(raw)
    for d in range(height + width - 1):
        y0, y1 = max(0, d - width + 1), min(d, height - 1)
        s = y0 * width + row + d + 1
        e = y1 * width + row + d + 2
        a = out[s - 1:e - 1:width]
        b = out[s - row:e - row:width]
        c = out[s - row - 1:e - row - 1:width]
        k = kind[s:e:width]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(k == 4, paeth, np.where(
            k == 3, (a + b) >> 1, np.where(k == 2, b, np.where(
                k == 1, a, 0))))
        out[s:e:width] = (raw[s:e:width] + pred) & 0xFF
    return out.reshape(height + 1, row, bpp)[1:, 1:].astype(
        np.uint8).reshape(height, stride)


def write_png(path, arr):
    """An 8- or 16-bit grayscale PNG of a 2-D uint8 or uint16 array (no
    filters, zlib level 6)."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes a 2-D uint8 or uint16 array, "
                         f"got {arr.dtype} {arr.shape}")
    height, width = arr.shape
    body = arr.astype(">u2") if arr.dtype == np.uint16 else arr
    rows = np.zeros((height, 1 + width * body.itemsize), np.uint8)
    rows[:, 1:] = body.reshape(height, -1).view(np.uint8)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data +
                struct.pack(">I", zlib.crc32(kind + data)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8 * arr.itemsize, 0, 0,
                       0, 0)
    with open(path, "wb") as fh:
        fh.write(_PNG_MAGIC + chunk(b"IHDR", ihdr) +
                 chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) +
                 chunk(b"IEND", b""))

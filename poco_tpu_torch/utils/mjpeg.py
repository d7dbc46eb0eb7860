"""Motion-JPEG without OpenCV or ffmpeg: AVI files and HTTP streams.

A Motion-JPEG video is a sequence of whole JPEG frames, and the port
decodes JPEG itself (`runtime/loader.decode_jpeg`: libjpeg on a host that
has it, nvJPEG on the card's). This module moves those frames in and
out of their containers, in plain Python:

    read_avi_mjpeg(path)                       -> iterator of JPEG bytes
    avi_frame_size(path)                       -> (height, width)
    write_avi_mjpeg(path, frames, fps, (w, h)) -> frame count
    iter_mjpeg_http(url)                       -> iterator of JPEG bytes

`read_avi_mjpeg` reads the AVI 1.0 files that cv2's and ffmpeg's MJPG
writers make (`RIFF AVI ` / `LIST movi`, also inside `LIST rec `); it
refuses an OpenDML file continued in `RIFF AVIX` lists and a video stream
that is not MJPG, naming cv2 and ffmpeg, which read those. `write_avi_mjpeg`
stores the frames unchanged with an `idx1` index, which cv2 and ffmpeg
read. `iter_mjpeg_http` reads a `multipart/x-mixed-replace` stream, the
Motion-JPEG that IP cameras serve over HTTP.
"""

from __future__ import annotations

import http.client
import os
import struct
import urllib.parse
from fractions import Fraction
from typing import BinaryIO, Iterable, Iterator

JPEG_SOI = b"\xff\xd8"
OTHER_READERS = "cv2.VideoCapture or ffmpeg reads it"


def _chunks(f: BinaryIO, end: int) -> Iterator[tuple[bytes, int, int]]:
    """(fourcc, payload offset, payload size) of each chunk from the file's
    position to `end`; a LIST's payload starts at its list type."""
    while f.tell() + 8 <= end:
        head = f.read(8)
        if len(head) < 8:
            return
        fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
        start = f.tell()
        yield fourcc, start, size
        f.seek(start + size + (size & 1))   # chunks are padded to even sizes


def _header(path: str) -> dict:
    """The RIFF header of an AVI: the `avih` size, each stream's type,
    handler and `strf` size, the `movi` list's span, and any `RIFF AVIX`."""
    info = {"streams": [], "movi": None, "avix": False, "avih": None}
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not an AVI file (no 'RIFF AVI ' header)")
        riff_end = 8 + struct.unpack("<I", head[4:8])[0]
        for fourcc, start, size in _chunks(f, riff_end):
            if fourcc != b"LIST":
                continue
            here = f.tell()
            f.seek(start)
            kind = f.read(4)
            if kind == b"hdrl":
                _read_hdrl(f, start + size, info)
            elif kind == b"movi" and info["movi"] is None:
                info["movi"] = (start, start + size)
            f.seek(here)
        f.seek(0, os.SEEK_END)
        file_end = f.tell()
        f.seek(riff_end + (riff_end & 1))
        while f.tell() + 12 <= file_end:   # OpenDML continues in further RIFF lists
            head = f.read(12)
            if head[:4] == b"RIFF" and head[8:12] == b"AVIX":
                info["avix"] = True
                break
            f.seek(f.tell() - 4 + struct.unpack("<I", head[4:8])[0])
    return info


def _read_hdrl(f: BinaryIO, end: int, info: dict) -> None:
    for fourcc, start, size in _chunks(f, end):
        here = f.tell()
        f.seek(start)
        if fourcc == b"avih":
            avih = f.read(min(size, 56))
            info["avih"] = struct.unpack("<10I", avih[:40])
        elif fourcc == b"LIST" and f.read(4) == b"strl":
            stream = {}
            for sub, s_start, s_size in _chunks(f, start + size):
                back = f.tell()
                f.seek(s_start)
                if sub == b"strh":
                    strh = f.read(s_size)
                    stream["type"], stream["handler"] = strh[:4], strh[4:8]
                elif sub == b"strf":
                    stream["strf"] = f.read(s_size)
                f.seek(back)
            info["streams"].append(stream)
        f.seek(here)


def _video_stream(path: str, info: dict) -> tuple[int, dict]:
    """The first video stream's number and header; raises unless it is MJPG."""
    for number, stream in enumerate(info["streams"]):
        if stream.get("type") != b"vids":
            continue
        strf = stream.get("strf", b"")
        compression = strf[16:20] if len(strf) >= 20 else b""
        handler = stream.get("handler", b"\0\0\0\0")
        if compression.upper() != b"MJPG" or handler.strip(b"\0 ") and handler.upper() != b"MJPG":
            raise ValueError(
                f"{path}: the video stream is {compression!r} (handler {handler!r}), not "
                f"Motion-JPEG (MJPG); the port reads MJPG AVI files only ({OTHER_READERS})")
        return number, stream
    raise ValueError(f"{path}: no video stream in the AVI header")


def avi_frame_size(path: str) -> tuple[int, int]:
    """(height, width) of an MJPG AVI's frames, from its video stream's
    `strf` (else the `avih` header): the video demo's probe."""
    info = _header(path)
    _, stream = _video_stream(path, info)
    strf = stream.get("strf", b"")
    if len(strf) >= 12:
        w, h = struct.unpack("<ii", strf[4:12])
        if w > 0 and h != 0:
            return abs(h), w
    if info["avih"] is None:
        raise ValueError(f"{path}: no frame size in the AVI header")
    return info["avih"][9], info["avih"][8]


def read_avi_mjpeg(path: str) -> Iterator[bytes]:
    """Each frame's JPEG bytes as stored, in file order: the `##dc` / `##db`
    chunks of the first video stream in `LIST movi` (and its `LIST rec `
    groups) whose payload starts with the JPEG start marker; `JUNK`, other
    streams and the index are skipped. Raises ValueError (naming cv2 and
    ffmpeg) for an OpenDML file continued past its first RIFF list and for
    a video stream that is not MJPG."""
    info = _header(path)
    number, _ = _video_stream(path, info)
    if info["avix"]:
        raise ValueError(f"{path}: an OpenDML AVI continued in 'RIFF AVIX' lists; the "
                         f"port reads AVI 1.0 files only ({OTHER_READERS})")
    if info["movi"] is None:
        raise ValueError(f"{path}: no 'LIST movi' in the AVI file")
    wanted = {b"%02ddc" % number, b"%02ddb" % number}
    start, end = info["movi"]
    with open(path, "rb") as f:
        f.seek(start + 4)
        spans = [end]
        while spans:
            if f.tell() + 8 > spans[-1]:
                spans.pop()
                continue
            head = f.read(8)
            if len(head) < 8:   # a file cut short ends its frames
                return
            fourcc, size = head[:4], struct.unpack("<I", head[4:])[0]
            if fourcc == b"LIST":   # 'rec ' groups hold a frame's chunks
                f.read(4)
                spans.append(f.tell() - 4 + size)
                continue
            here = f.tell()
            if fourcc in wanted:
                data = f.read(size)
                if data[:2] == JPEG_SOI:
                    yield data
            f.seek(here + size + (size & 1))


def _fps_fraction(fps: float) -> tuple[int, int]:
    frac = Fraction(fps).limit_denominator(1001)
    if frac <= 0:
        raise ValueError(f"fps must be positive, not {fps}")
    return frac.numerator, frac.denominator


def write_avi_mjpeg(path: str, jpeg_frames: Iterable[bytes], fps: float,
                    size: tuple[int, int]) -> int:
    """Write JPEG frames, stored unchanged, as an MJPG AVI 1.0 file: `avih`,
    one video stream (`strh` / `strf`, handler MJPG), `LIST movi` of `00dc`
    chunks and an `idx1` index; `size` is (width, height). The frames are
    streamed to the file and the counts patched in at the end. Returns the
    number of frames written."""
    w, h = size
    rate, scale = _fps_fraction(fps)
    index = []
    largest = 0
    with open(path, "wb") as f:
        f.write(b"RIFF\0\0\0\0AVI ")
        hdrl = b"hdrl"
        avih_at = 12 + 8 + 4 + 8
        avih = struct.pack("<14I", round(1e6 * scale / rate), 0, 0, 0x10, 0, 0, 1, 0, w, h,
                           0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"MJPG", 0, 0, 0, 0, scale, rate,
                           0, 0, 0, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        strl = b"strl" + b"strh" + struct.pack("<I", len(strh)) + strh + \
            b"strf" + struct.pack("<I", len(strf)) + strf
        hdrl += b"avih" + struct.pack("<I", len(avih)) + avih + \
            b"LIST" + struct.pack("<I", len(strl)) + strl
        f.write(b"LIST" + struct.pack("<I", len(hdrl)) + hdrl)
        strh_at = avih_at + len(avih) + 8 + 4 + 8
        movi_at = f.tell()
        f.write(b"LIST\0\0\0\0movi")
        for data in jpeg_frames:
            data = bytes(data)
            if data[:2] != JPEG_SOI:
                raise ValueError(f"frame {len(index)} is not a JPEG (no start marker)")
            index.append((f.tell() - (movi_at + 8), len(data)))
            f.write(b"00dc" + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1))
            largest = max(largest, len(data))
        movi_end = f.tell()
        f.write(b"idx1" + struct.pack("<I", 16 * len(index)))
        for offset, length in index:
            f.write(struct.pack("<4sIII", b"00dc", 0x10, offset, length))
        riff_end = f.tell()
        for at, value in ((4, riff_end - 8), (movi_at + 4, movi_end - movi_at - 8),
                          (avih_at + 16, len(index)), (avih_at + 28, largest),
                          (strh_at + 32, len(index)), (strh_at + 36, largest)):
            f.seek(at)
            f.write(struct.pack("<I", value))
    return len(index)


class _Body:
    """A buffered reader over an HTTP response body."""

    def __init__(self, response: http.client.HTTPResponse):
        self.response = response
        self.buf = b""

    def _more(self) -> bool:
        data = self.response.read1(65536)
        self.buf += data
        return bool(data)

    def readline(self) -> bytes | None:
        while b"\n" not in self.buf:
            if not self._more():
                return None
        line, self.buf = self.buf.split(b"\n", 1)
        return line.rstrip(b"\r")

    def read(self, n: int) -> bytes | None:
        while len(self.buf) < n:
            if not self._more():
                return None
        data, self.buf = self.buf[:n], self.buf[n:]
        return data

    def read_until(self, marker: bytes) -> bytes | None:
        """The bytes before `marker`, which stays in the buffer."""
        seen = 0
        while (at := self.buf.find(marker, seen)) < 0:
            seen = max(0, len(self.buf) - len(marker))
            if not self._more():
                return None
        data, self.buf = self.buf[:at], self.buf[at:]
        return data


def _boundary(content_type: str, url: str) -> bytes:
    kind, _, params = content_type.partition(";")
    if kind.strip().lower() != "multipart/x-mixed-replace":
        raise ValueError(f"{url}: Content-Type {content_type!r} is not a Motion-JPEG "
                         f"stream (multipart/x-mixed-replace)")
    for param in params.split(";"):
        key, _, value = param.strip().partition("=")
        if key.lower() == "boundary" and value.strip().strip('"').strip("-"):
            # some cameras put the delimiter's own dashes in the parameter as
            # well: the dashes are left out on both sides of the match
            return value.strip().strip('"').strip("-").encode()
    raise ValueError(f"{url}: no boundary in Content-Type {content_type!r}")


def iter_mjpeg_http(url: str, timeout: float = 30.0) -> Iterator[bytes]:
    """Each JPEG of a `multipart/x-mixed-replace` HTTP stream, as sent.

    The boundary comes from the response's Content-Type. A part is read
    to its `Content-Length` where it has one, otherwise to the next
    boundary; a part that is not a JPEG is skipped. The iterator ends at
    the closing boundary or when the server closes the stream, and the
    connection is closed when it ends or is closed."""
    parts = urllib.parse.urlsplit(url)
    if parts.scheme not in ("http", "https"):
        raise ValueError(f"{url}: not an http(s) URL")
    conn_type = http.client.HTTPSConnection if parts.scheme == "https" else \
        http.client.HTTPConnection
    conn = conn_type(parts.hostname, parts.port, timeout=timeout)
    try:
        conn.request("GET", (parts.path or "/") + (f"?{parts.query}" if parts.query else ""))
        response = conn.getresponse()
        if response.status != 200:
            raise ValueError(f"{url}: HTTP {response.status} {response.reason}")
        boundary = _boundary(response.getheader("Content-Type", ""), url)
        body = _Body(response)
        while True:
            line = body.readline()
            if line is None:
                return
            line = line.strip().lstrip(b"-")
            if not line.startswith(boundary):
                continue
            if line[len(boundary):].startswith(b"--"):
                return   # the closing delimiter
            headers = {}
            while (line := body.readline()):
                key, _, value = line.decode("latin-1").partition(":")
                headers[key.strip().lower()] = value.strip()
            if line is None:
                return
            length = headers.get("content-length")
            if length is not None:
                data = body.read(int(length))
            else:
                data = body.read_until(boundary)
                if data is not None:   # less the delimiter's dashes and line break
                    data = data.rstrip(b"-").removesuffix(b"\n").removesuffix(b"\r")
            if data is None:
                return
            if data[:2] == JPEG_SOI:
                yield data
    finally:
        conn.close()


class MjpegHttpServer:
    """Serve JPEG frames once as a `multipart/x-mixed-replace` stream from a
    thread, as an IP camera serves Motion-JPEG: a recorded stream replayed
    on loopback (`url`; port 0 takes a free one). `content_length=False`
    leaves the parts' Content-Length out, as some cameras do. A context
    manager: leaving it stops the server and joins its thread."""

    BOUNDARY = "pocoframe"

    def __init__(self, frames: list[bytes], host: str = "127.0.0.1", port: int = 0,
                 content_length: bool = True):
        import http.server
        import threading

        frames = [bytes(f) for f in frames]
        boundary = self.BOUNDARY

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                self.send_response(200)
                self.send_header("Content-Type",
                                 f"multipart/x-mixed-replace; boundary={boundary}")
                self.end_headers()
                for data in frames:
                    head = f"--{boundary}\r\nContent-Type: image/jpeg\r\n"
                    if content_length:
                        head += f"Content-Length: {len(data)}\r\n"
                    self.wfile.write(head.encode() + b"\r\n" + data + b"\r\n")
                self.wfile.write(f"--{boundary}--\r\n".encode())

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.url = f"http://{host}:{self.httpd.server_address[1]}/stream.mjpg"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def __enter__(self) -> "MjpegHttpServer":
        return self

    def __exit__(self, *exc) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)

"""RCSB structure fetcher with an injectable transport: the port's copy of
``timed_design_tpu/io/fetch.py``.

``td-analyse-rotamers --allow-fetch`` downloads a structure missing from the
local mirror. The transport is a plain ``opener(url) -> bytes`` callable, so
tests drive it against a localhost HTTP server and air-gapped deployments
can plug in an internal mirror. Fetching is off unless asked for.
"""
from __future__ import annotations

import typing as t
from pathlib import Path

RCSB_BASE_URL = "https://files.rcsb.org/download/"

GZIP_MAGIC = b"\x1f\x8b"


def _looks_like_pdb(data: bytes) -> bool:
    """True when ``data`` contains at least one PDB record line: the coarse
    check that keeps HTML error pages served with status 200 out of the
    mirror."""
    head = data[:65536]
    return any(
        marker in head
        for marker in (b"\nATOM  ", b"\nHETATM", b"\nHEADER")
    ) or head.startswith((b"ATOM  ", b"HETATM", b"HEADER"))


def default_opener(url: str, timeout: float = 30.0) -> bytes:
    """The stdlib transport: GET the URL, return the body bytes."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def fetch_pdb(
    pdb_code: str,
    output_folder: Path,
    *,
    base_url: str = RCSB_BASE_URL,
    opener: t.Callable[[str], bytes] | None = None,
    verbosity: int = 1,
) -> Path:
    """Download a structure into ``output_folder`` and return its path.

    Tries the biological-assembly names of the mirror layout:
    ``{code}.pdb1.gz``, then ``{code}.pdb1``, then ``{code}.pdb``. A ``.gz``
    response without the gzip magic counts as a miss, and so does a response
    without any PDB record line (a proxy's error page served with status
    200): a poisoned mirror would crash every later run in the parser.
    Raises ``FileNotFoundError`` when no candidate exists.
    """
    code = pdb_code[:4].lower()
    opener = opener or default_opener
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    last_err: Exception | None = None
    for name in (f"{code}.pdb1.gz", f"{code}.pdb1", f"{code}.pdb"):
        url = base_url + name
        try:
            data = opener(url)
        except OSError as e:  # HTTPError/URLError are OSError subclasses
            last_err = e
            continue
        if name.endswith(".gz"):
            if not data.startswith(GZIP_MAGIC):
                last_err = ValueError(f"{url}: response is not gzip data")
                continue
            # content-validate the DECOMPRESSED head too: a proxy error
            # page served gzip-compressed passes the magic check but would
            # poison the mirror just the same
            import gzip as _gzip
            import io as _io
            import zlib as _zlib

            try:
                head = _gzip.GzipFile(fileobj=_io.BytesIO(data)).read(65536)
            except (OSError, EOFError, _zlib.error):
                # EOFError: truncated stream; zlib.error: corrupt deflate —
                # neither is an OSError subclass, and both must count as a
                # candidate miss, not abort the whole fetch
                last_err = ValueError(f"{url}: corrupt gzip data")
                continue
            if not _looks_like_pdb(head):
                last_err = ValueError(f"{url}: response has no PDB records")
                continue
        elif not _looks_like_pdb(data):
            last_err = ValueError(f"{url}: response has no PDB records")
            continue
        out = output_folder / name
        out.write_bytes(data)
        if verbosity:
            print(f"Fetched {code} -> {out}")
        return out
    raise FileNotFoundError(
        f"Could not fetch {pdb_code!r} from {base_url} "
        f"(last error: {last_err})"
    )


def make_fetcher(
    pdb_dir: Path,
    *,
    base_url: str = RCSB_BASE_URL,
    opener: t.Callable[[str], bytes] | None = None,
) -> t.Callable[[str], Path]:
    """A ``code -> Path`` closure that downloads into the two-character
    sharded mirror layout (``pdb_dir/<code[1:3]>/``), so fetched files are
    found locally next time."""

    def fetcher(code: str) -> Path:
        return fetch_pdb(
            code, Path(pdb_dir) / code[1:3].lower(),
            base_url=base_url, opener=opener,
        )

    return fetcher

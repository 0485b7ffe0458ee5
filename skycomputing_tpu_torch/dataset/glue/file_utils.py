"""Resource resolution for dataset assets (the port's own copy of
``skycomputing_tpu/dataset/glue/file_utils.py``; stdlib only).

``cached_path`` resolves local filesystem paths (absolute, relative, or
under ``SKYTPU_DATA_HOME``) and refuses remote URLs with the reason
instead of attempting a download: the runtime is offline by design.
The API shape (path in, usable path out) is that of the reference
``scaelum/dataset/glue/file_utils.py``, so dataset code written against
it keeps working when pointed at local assets.
"""

from __future__ import annotations

import os
from typing import Optional
from urllib.parse import urlparse

DATA_HOME_ENV = "SKYTPU_DATA_HOME"


def url_to_filename(url: str, etag: Optional[str] = None) -> str:
    """Deterministic cache filename for a resource identifier."""
    import hashlib

    name = hashlib.sha256(url.encode()).hexdigest()
    if etag:
        name += "." + hashlib.sha256(etag.encode()).hexdigest()[:16]
    return name


def cached_path(path_or_url: str, cache_dir: Optional[str] = None) -> str:
    """Resolve a resource to a local path.

    Local paths are returned (after existence check, trying
    ``$SKYTPU_DATA_HOME`` as a base for relative paths); ``http(s)://`` and
    ``s3://`` raise with an actionable message, because this runtime has no
    network egress.
    """
    parsed = urlparse(path_or_url)
    if parsed.scheme in ("http", "https", "s3"):
        raise OSError(
            f"cannot fetch {path_or_url!r}: this runtime has no network "
            f"egress. Download the resource out-of-band and pass its local "
            f"path (or set ${DATA_HOME_ENV} and use a relative path)."
        )

    if os.path.exists(path_or_url):
        return path_or_url

    data_home = os.environ.get(DATA_HOME_ENV)
    if data_home:
        candidate = os.path.join(data_home, path_or_url)
        if os.path.exists(candidate):
            return candidate

    raise FileNotFoundError(
        f"resource {path_or_url!r} not found locally"
        + (f" (also tried under ${DATA_HOME_ENV}={data_home})" if data_home
           else f" (set ${DATA_HOME_ENV} to add a search base)")
    )


__all__ = ["cached_path", "url_to_filename", "DATA_HOME_ENV"]

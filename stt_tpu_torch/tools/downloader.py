"""Archive downloader with progress reporting.

The port's copy of `stt_tpu.tools.downloader`, the counterpart of the
reference's util/downloader.py:18-37 (requests+tqdm),
built on stdlib urllib so it works in the bare environment. Downloads go
through stt_tpu_torch.io, so a remote target_dir (gs://...) works too.

maybe_download is a no-op whenever the archive already exists locally,
so on a machine without network access the importers run from an archive
dropped in place.
"""

from __future__ import annotations

import os
import sys
import urllib.request

from stt_tpu_torch.io import is_remote_path, open_remote, path_exists_remote


def _progress(done: int, total: int, out=sys.stderr) -> None:
    if total > 0:
        pct = 100.0 * done / total
        out.write(f"\rProgress {pct:5.1f}% ({done}/{total} bytes)")
    else:
        out.write(f"\rProgress {done} bytes")
    out.flush()


def maybe_download(archive_name: str, target_dir: str, archive_url: str,
                   chunk_size: int = 1 << 20) -> str:
    """Download archive_url to target_dir/archive_name unless it exists.

    Returns the archive path either way (reference contract:
    util/downloader.py:18)."""
    archive_path = os.path.join(target_dir, archive_name)
    if not is_remote_path(target_dir) and not os.path.exists(target_dir):
        print(f'No path "{target_dir}" - creating ...')
        os.makedirs(target_dir)
    if path_exists_remote(archive_path):
        print(f'Found archive "{archive_path}" - not downloading.')
        return archive_path

    print(f'No archive "{archive_path}" - downloading...')
    req = urllib.request.Request(archive_url)
    with urllib.request.urlopen(req, timeout=120) as resp:
        total = int(resp.headers.get("Content-Length", 0))
        done = 0
        with open_remote(archive_path, "wb") as f:
            while True:
                chunk = resp.read(chunk_size)
                if not chunk:
                    break
                f.write(chunk)
                done += len(chunk)
                _progress(done, total)
    sys.stderr.write("\n")
    return archive_path

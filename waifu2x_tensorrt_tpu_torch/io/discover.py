"""Input-file discovery (reference utils::findFilesByExtension,
src/utilities/path.h:7-37).

Regular files are matched by the extension whitelist; directories are
iterated (optionally recursively). The default whitelist matches
src/main.cpp:156-159 (where ``.avi`` is listed twice; a set here).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv")
DEFAULT_EXTENSIONS = IMAGE_EXTENSIONS + VIDEO_EXTENSIONS


def find_files_by_extension(
    paths: Iterable[str | Path],
    extensions: Sequence[str] = DEFAULT_EXTENSIONS,
    recursive: bool = False,
) -> list[Path]:
    exts = {e.lower() for e in extensions}
    found: list[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_file():
            if p.suffix.lower() in exts:
                found.append(p)
        elif p.is_dir():
            it = p.rglob("*") if recursive else p.glob("*")
            for child in sorted(it):
                if child.is_file() and child.suffix.lower() in exts:
                    found.append(child)
    return found

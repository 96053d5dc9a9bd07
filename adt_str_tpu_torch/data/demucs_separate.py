"""Drum-stem separation through the `demucs` CLI.

Port of `adt_str_tpu/data/demucs_separate.py`: runs `demucs -n <model>
--two-stems drums -o <output_dir> <file>` for each file in a subprocess and
renames the stems to `<output_dir>/<stem>_drums.wav` and
`<stem>_no_drums.wav`. Without the `demucs` CLI it raises; two inputs
with one basename raise before the first run (demucs keys its outputs by
the stem).
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)


def separate_drums(files: list[str], output_dir: str = "demucs_output", model: str = "htdemucs") -> list[Path]:
    """-> the drum stems written, in input order (a file without one is logged and left out)."""
    if shutil.which("demucs") is None:
        raise RuntimeError("demucs CLI not found: install demucs to run drum-stem separation, or pass --skip-demucs")
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    stems = [Path(f).stem for f in files]
    dupes = {s for s in stems if stems.count(s) > 1}
    if dupes:
        raise ValueError(f"duplicate input basenames {sorted(dupes)}: demucs outputs are keyed by stem; rename the "
                         "inputs or separate in batches")
    results: list[Path] = []
    for file in files:
        file_path = Path(file)
        subprocess.run(["demucs", "-n", model, "--two-stems", "drums", "-o", str(output_dir), str(file_path)],
                       check=True)
        song = output_dir / model / file_path.stem
        drum_path = song / "drums.wav"
        if drum_path.exists():
            final_path = output_dir / f"{file_path.stem}_drums.wav"
            drum_path.rename(final_path)
            results.append(final_path)
        else:
            logger.warning("demucs produced no drums stem for %s", file)
        nodrum_path = song / "no_drums.wav"
        if nodrum_path.exists():
            nodrum_path.rename(output_dir / f"{file_path.stem}_no_drums.wav")
    return results

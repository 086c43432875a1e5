"""Write the JPEG fixtures of the native data-plane checks.

    python -m sprc_tpu_torch.data.dataplane_fixtures [--out tests/fixtures/dataplane]

Five JPEGs from seeded pixels (quality 75 and 95, RGB and grayscale, an odd
size, a wide and a tall image that targetpad pads), each with Pillow's
decode (``<name>.decode.npy``, uint8 RGB ``[H, W, 3]``) and Pillow's
``targetpad_transform(1.25, 32)`` output (``<name>.targetpad32.npy``, float32
``[32, 32, 3]``) beside it. Pillow is needed to write them, not to read
them: ``tests/test_torch_dataplane.py`` and ``chip_smoke.py`` hold the
port's decoder against the stored arrays.
"""

from __future__ import annotations

import argparse
import io
import os

import numpy as np

# name -> (height, width, mode, quality)
FIXTURES = {
    "rgb_q95_48x64": (48, 64, "RGB", 95),
    "rgb_q75_37x53": (37, 53, "RGB", 75),
    "gray_q75_64x48": (64, 48, "L", 75),
    "rgb_q95_40x100": (40, 100, "RGB", 95),
    "gray_q95_90x30": (90, 30, "L", 95),
}
TARGETPAD_DIM = 32
SEED = 0


def write(out: str) -> list:
    import PIL.Image

    from sprc_tpu_torch.data.transforms import targetpad_transform

    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(SEED)
    written = []
    for name, (h, w, mode, quality) in FIXTURES.items():
        # smooth seeded pixels (noise does not survive JPEG): a low-resolution
        # random grid, upsampled
        grid = rng.integers(0, 256, (4, 4, 3 if mode == "RGB" else 1), dtype=np.uint8)
        img = PIL.Image.fromarray(grid.squeeze(-1) if mode == "L" else grid, mode)
        img = img.resize((w, h), PIL.Image.BICUBIC)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=quality)
        path = os.path.join(out, f"{name}.jpg")
        with open(path, "wb") as f:
            f.write(buf.getvalue())
        decoded = PIL.Image.open(io.BytesIO(buf.getvalue()))
        np.save(os.path.join(out, f"{name}.decode.npy"), np.asarray(decoded.convert("RGB")))
        np.save(os.path.join(out, f"{name}.targetpad{TARGETPAD_DIM}.npy"),
                targetpad_transform(1.25, TARGETPAD_DIM)(decoded))
        written.append(path)
    return written


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tests", "fixtures", "dataplane"))
    for path in write(ap.parse_args().out):
        print(path)

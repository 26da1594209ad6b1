"""Score a directory of WAVs with the DNSMOS P.835/P.808 ONNX models
(counterpart of ``tools/dns_mos.py``):

    python -m spiking_fullsubnet_torch.tools.dns_mos -D wav_dir -O dnsmos.csv \\
        [--sr 16000] [--model_dir DIR] [--no_p808] [--device cuda|cpu]

Needs onnxruntime and the DNSMOS ONNX files (default: the bundle under
``model_zoo/external/DNSMOS/``, or ``$DNSMOS_MODEL_DIR``). The models run on
``--device`` (onnxruntime's CUDA provider on the card). The CSV has the JAX
tool's columns: ``file`` (the path), then the scores.
"""

from __future__ import annotations

import argparse

from ..dsp.io import find_files, load_wav
from ..metrics import DNSMOS
from ..runtime.device import resolve_device
from ._common import add_device, markdown_row, numeric_means, onnx_device, write_csv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-D", "--dir", required=True, help="directory of wavs to score")
    p.add_argument("-O", "--output", default="dnsmos.csv")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--no_p808", action="store_true")
    add_device(p)
    args = p.parse_args(argv)

    mos = DNSMOS(input_sr=args.sr, device=onnx_device(resolve_device(args.device)),
                 model_dir=args.model_dir)
    rows = []
    for f in find_files(args.dir):
        y = load_wav(f, sr=args.sr)
        rows.append({"file": f} | mos(y, return_p808=not args.no_p808))
    write_csv(rows, args.output)
    print(markdown_row(numeric_means(rows)))


if __name__ == "__main__":
    main()

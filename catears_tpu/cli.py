"""Command-line decoder (reference src/main.cc parity).

Usage: python -m catears_tpu.cli [--batch[=N]] <config-file> <input-file>
  *.wav: decode this file, print the hypothesis.
  *.scp: decode `name path` entries, print `name hyp` per line.
  --batch[=N]: decode scp entries N at a time in one batched device beam
               search (default N=16) instead of one-by-one streaming.
"""

from __future__ import annotations

import sys

from catears_tpu.io.wav import read_scp
from catears_tpu.runtime.recognizer import Recognizer, decode_wav_file
from catears_tpu.utils.device import enable_compile_cache
from catears_tpu.utils.errors import CatEarsError


def print_usage() -> None:
    print("Usage: catears [--batch[=N]] <model-config> <input-file>")
    print("  Input-file:")
    print("    *.wav: decode this file.")
    print("    *.scp: decode audios listed in it.")
    sys.exit(1)


def main(argv=None) -> int:
    # The decode programs take tens of seconds to compile; the disk cache
    # spares repeat CLI runs that cost.
    enable_compile_cache()
    argv = list(argv) if argv is not None else sys.argv[1:]
    batch_size = 0
    for arg in list(argv):
        if arg == "--batch":
            batch_size = 16
            argv.remove(arg)
        elif arg.startswith("--batch="):
            batch_size = int(arg.split("=", 1)[1])
            argv.remove(arg)
    if len(argv) != 2:
        print_usage()
    config_file, input_file = argv
    if len(input_file) < 4:
        print_usage()

    # The reference CLI reports failures as one-line errors and exits
    # (src/main.cc:15-25) rather than dumping a stack.
    try:
        return _run(config_file, input_file, batch_size)
    except (CatEarsError, OSError) as e:
        print(f"catears: {e}", file=sys.stderr)
        return 1


def _run(config_file: str, input_file: str, batch_size: int) -> int:
    recognizer = Recognizer(config_file)
    if input_file.endswith(".wav"):
        print(decode_wav_file(recognizer, input_file))
    elif batch_size > 0:
        from catears_tpu.runtime.batch import decode_scp
        for name, hyp in decode_scp(recognizer, input_file,
                                    batch_size=batch_size):
            print(f"{name} {hyp}")
    else:
        for name, wav_path in read_scp(input_file):
            hyp = decode_wav_file(recognizer, wav_path)
            print(f"{name} {hyp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

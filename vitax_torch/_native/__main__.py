"""Build the native data-path library ahead of time:

    python -m vitax_torch._native

Exit 0 with the library's path; 1, with the reason, when g++, libjpeg or
its header is missing or the build fails."""

import sys

if __name__ == "__main__":
    from vitax_torch import _native

    if _native.load() is None:
        print(f"native library unavailable: {_native.unavailable_reason()}", file=sys.stderr)
        sys.exit(1)
    print(f"native library ready: {_native.lib_path()}")

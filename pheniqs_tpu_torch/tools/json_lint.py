"""JSON lint/pretty-print utility (reference tool/json_lint.py): validate
stdin JSON and emit it pretty (-p/--pretty, default) or compact
(-c/--compact), keys sorted."""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    compact = any(arg in ("-c", "--compact") for arg in argv)
    try:
        document = json.load(sys.stdin)
    except json.JSONDecodeError as error:
        sys.stderr.write(f"invalid JSON: {error}\n")
        return 10  # JSON validation error code (reference error.h:43)
    print(
        json.dumps(
            document,
            sort_keys=True,
            ensure_ascii=True,
            allow_nan=False,
            indent=None if compact else 4,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

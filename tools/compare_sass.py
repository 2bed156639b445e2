#!/usr/bin/env python3
"""Compare the SASS of the kernels two builds of the port's kernel library
share, function by function (``cuobjdump -sass``, on a machine with the
CUDA toolkit):

    python3 tools/compare_sass.py OLD.so NEW.so

Each kernel of OLD is matched in NEW by its mangled name, with the
per-file hash of the anonymous namespace taken out; the SASS text is
compared with its address comments and its column padding (which
cuobjdump sets per file) taken out. Prints one JSON line per
kernel of OLD (SASS lines in each, whether they are the same, and where
they are not, how many lines differ and the first three pairs) and a
last line with the counts; exits 1 if a kernel of OLD is missing from NEW
or compiles to other SASS.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nnueehcs_tpu_torch.sass import dump, parse_functions  # noqa: E402


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (parse_functions(dump(p)) for p in argv)
    same = 0
    for name, sass in sorted(old.items()):
        other = new.get(name)
        equal = other == sass
        same += equal
        row = {'kernel': name, 'old_lines': len(sass),
               'new_lines': None if other is None else len(other),
               'same_sass': equal}
        if other is not None and not equal:
            diffs = [(a, b) for a, b in zip(sass, other) if a != b]
            row['lines_that_differ'] = len(diffs)
            row['first_differences'] = diffs[:3]
        print(json.dumps(row))
    print(json.dumps({'kernels_in_old': len(old), 'same_sass': same,
                      'kernels_only_in_new': sorted(set(new) - set(old))}))
    return 0 if same == len(old) else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
r"""Compare the SASS of the kernels two builds of the port's kernel library
share, function by function (``cuobjdump -sass``, on a machine with the
CUDA toolkit):

    python3 tools/compare_sass.py OLD.so NEW.so [--rename PATTERN REPL]...

Each kernel of OLD is matched in NEW by its mangled name, with the
per-file hash of the anonymous namespace taken out (and, with
``--rename``, each regular expression PATTERN of an OLD name replaced by
REPL first, ``re.sub``'s syntax: a kernel that gained a template
parameter, such as ``ILb(\d)ELb(\d)EEEvNS_4Args`` to
``ILb\1ELb\2ELi0EEEvNS_4Args``); the SASS text is compared with its
address comments and its column padding (which cuobjdump sets per file)
taken out. Prints one JSON line per kernel of OLD (SASS lines in each,
whether they are the same, and where they are not, how many lines differ
and the first three pairs) and a last line with the counts; exits 1 if a
kernel of OLD is missing from NEW or compiles to other SASS.
"""
import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nnueehcs_tpu_torch.sass import dump, parse_functions  # noqa: E402


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('old')
    parser.add_argument('new')
    parser.add_argument('--rename', nargs=2, action='append', default=[],
                        metavar=('PATTERN', 'REPL'))
    args = parser.parse_args(argv)
    old, new = (parse_functions(dump(p)) for p in (args.old, args.new))
    same, names = 0, set()
    for name, sass in sorted(old.items()):
        for pattern, repl in args.rename:
            name = re.sub(pattern, repl, name)
        names.add(name)
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
                      'kernels_only_in_new': sorted(set(new) - names)}))
    return 0 if same == len(old) else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

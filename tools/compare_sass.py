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
import re
import shutil
import subprocess
import sys
from pathlib import Path

_ANON = re.compile(r'_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}')
_ADDR = re.compile(r'/\*[0-9a-f]{4,}\*/')


def cuobjdump():
    found = shutil.which('cuobjdump')
    return found or str(Path('/usr/local/cuda/bin/cuobjdump'))


def functions(lib):
    """{normalised mangled name: [SASS lines]} of ``lib``: each
    instruction with its encoding, and the control words."""
    out = subprocess.run([cuobjdump(), '-sass', str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        head = re.match(r'\s*Function : (\S+)', line)
        if head:
            name = _ANON.sub('_GLOBAL_', head.group(1))
            funcs[name] = []
        elif name is not None and '/*' in line:   # instructions, control
            funcs[name].append(' '.join(_ADDR.sub('', line).split()))
    return funcs


def main(argv):
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (functions(p) for p in argv)
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

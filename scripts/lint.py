"""Minimal in-repo linter (the image ships no flake8/ruff).

Checks: syntax (compile), unused imports, max line length 120, tabs,
trailing whitespace.  Exit 1 on any finding.
"""

import ast
import sys
from pathlib import Path

MAX_LINE = 120
ROOT = Path(__file__).resolve().parent.parent
TARGETS = ["doppelspeller", "tests", "bench.py", "__graft_entry__.py", "scripts"]

findings = []


def check_unused_imports(tree: ast.AST, path: Path) -> None:
    imported = {}  # name -> lineno
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = (a.asname or a.name).split(".")[0]
                imported[name] = node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                imported[a.asname or a.name] = node.lineno
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    src = path.read_text()
    for name, lineno in sorted(imported.items(), key=lambda kv: kv[1]):
        if name in used:
            continue
        # crude noqa + __all__ re-export escape hatches
        line = src.splitlines()[lineno - 1]
        if "noqa" in line or f'"{name}"' in src or f"'{name}'" in src:
            continue
        findings.append(f"{path}:{lineno}: unused import '{name}'")


def check_file(path: Path) -> None:
    src = path.read_text()
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as exc:
        findings.append(f"{path}:{exc.lineno}: syntax error: {exc.msg}")
        return
    check_unused_imports(tree, path)
    for i, line in enumerate(src.splitlines(), 1):
        if len(line) > MAX_LINE:
            findings.append(f"{path}:{i}: line too long ({len(line)} > {MAX_LINE})")
        if "\t" in line:
            findings.append(f"{path}:{i}: tab character")
        if line != line.rstrip():
            findings.append(f"{path}:{i}: trailing whitespace")


def main() -> int:
    for target in TARGETS:
        p = ROOT / target
        files = [p] if p.suffix == ".py" else sorted(p.rglob("*.py"))
        for f in files:
            check_file(f)
    for f in findings:
        print(f)
    print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""Typed CLI/params-file argument parser (helib_tpu.argmap).

Role of HElib's ArgMap (include/helib/ArgMap.h:72-180):
fluent registration of required/optional/toggle args, parsed from argv
(`name=value` or whitespace-separated) or from a params file.
"""

from __future__ import annotations

import sys


class ArgMapError(ValueError):
    pass


class ArgMap:
    def __init__(self):
        self._specs: dict = {}
        self._required: set = set()
        self._toggles: dict = {}
        self._positional: list = []
        self._docs: dict = {}

    def arg(self, name: str, default, doc: str = ""):
        """Optional typed argument; type inferred from default."""
        self._specs[name] = [type(default), default]
        self._docs[name] = doc
        return self

    def required(self):
        """Mark the most recently added arg as required."""
        if self._specs:
            self._required.add(next(reversed(self._specs)))
        return self

    def toggle(self, name: str, default: bool = False, doc: str = ""):
        self._specs[name] = [bool, default]
        self._toggles[name] = True
        self._docs[name] = doc
        return self

    def note(self, doc: str):
        self._docs.setdefault("_notes", "")
        self._docs["_notes"] += doc + "\n"
        return self

    def usage(self, file=None):
        file = file or sys.stderr
        print("arguments:", file=file)
        for name, (typ, default) in self._specs.items():
            req = " (required)" if name in self._required else f" [={default}]"
            print(f"  {name}: {typ.__name__}{req}  {self._docs.get(name, '')}",
                  file=file)

    def parse(self, argv=None) -> dict:
        argv = list(sys.argv[1:] if argv is None else argv)
        out = {k: v for k, (t, v) in self._specs.items()}
        seen = set()
        i = 0
        while i < len(argv):
            tok = argv[i]
            if tok in ("-h", "--help"):
                self.usage()
                raise SystemExit(0)
            if "=" in tok:
                name, val = tok.split("=", 1)
            elif tok in self._toggles:
                name, val = tok, "1"
            else:
                name = tok
                i += 1
                if i >= len(argv):
                    raise ArgMapError(f"missing value for {name}")
                val = argv[i]
            if name not in self._specs:
                raise ArgMapError(f"unknown argument {name}")
            typ = self._specs[name][0]
            if typ is bool:
                out[name] = val.lower() not in ("0", "false", "off", "")
            else:
                out[name] = typ(val)
            seen.add(name)
            i += 1
        missing = self._required - seen
        if missing:
            raise ArgMapError(f"missing required arguments: {sorted(missing)}")
        return out

    def parse_file(self, path: str) -> dict:
        toks = []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    toks.extend(line.split())
        return self.parse(toks)

"""Legacy pre-1.0 `.jl` parameter-file support.

A copy of latticeqcd_tpu/system/legacy_input.py, pinned to the original
below this docstring by tests/test_torch_import.py; its one change is
``transform_to_toml``'s import of ``write_toml``, which comes from the
port's wizard. Counterpart of LatticeQCD.jl's transform_oldinputfile.jl
(src/system/transform_oldinputfile.jl:120-258): the old format is Julia
assignments into four dicts (system, actions, md, measurement, as in the
reference's test/test01.jl). The reference `include`s the file, which runs
arbitrary code; here the Julia literals are transliterated to Python
expressions and evaluated by a restricted AST walker (_safe_eval) that only
admits literals, container displays, basic arithmetic, subscripts into the
parsed dicts, and the two transliteration helpers: no attribute access, no
names outside the namespace, no arbitrary calls (a bare `eval` with empty
__builtins__ is escapable via attribute chains).
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict


def _dictcall(*args):
    return dict(zip(args[0::2], args[1::2]))


def _undef_dicts(n):
    """Array{Dict,1}(undef, n) followed by the fill loop -> n fresh dicts."""
    return [{} for _ in range(int(n))]


_REPLACEMENTS = [
    (re.compile(r"Array\{Dict,\s*1\}\(\s*undef\s*,\s*(\d+)\s*\)"), r"_undef_dicts(\1)"),
    (re.compile(r"Dict\{[^}]*\}\("), "_D("),
    (re.compile(r"\bDict\["), "["),
    (re.compile(r"\bAny\["), "["),
    (re.compile(r"=>"), ","),
    (re.compile(r"\bnothing\b"), "None"),
    (re.compile(r"\btrue\b"), "True"),
    (re.compile(r"\bfalse\b"), "False"),
    (re.compile(r"÷"), "//"),
]


_BINOPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Pow: lambda a, b: a ** b,
    ast.Mod: lambda a, b: a % b,
}
_UNARYOPS = {ast.UAdd: lambda a: +a, ast.USub: lambda a: -a}


def _safe_eval(node: ast.AST, namespace: Dict[str, Any]):
    """Evaluate the tiny expression grammar legacy files actually use:
    literals, lists/tuples, +-*/÷^% arithmetic, string subscripts into
    the parsed dicts (e.g. 1/md["MDsteps"]), and calls to the two
    transliteration helpers. Everything else (attribute access, names
    outside the namespace, arbitrary calls) raises ValueError."""
    if isinstance(node, ast.Expression):
        return _safe_eval(node.body, namespace)
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.List, ast.Tuple)):
        vals = [_safe_eval(e, namespace) for e in node.elts]
        return vals if isinstance(node, ast.List) else tuple(vals)
    if isinstance(node, ast.BinOp) and type(node.op) in _BINOPS:
        return _BINOPS[type(node.op)](
            _safe_eval(node.left, namespace), _safe_eval(node.right, namespace)
        )
    if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARYOPS:
        return _UNARYOPS[type(node.op)](_safe_eval(node.operand, namespace))
    if isinstance(node, ast.Name):
        if node.id in namespace and not callable(namespace[node.id]):
            return namespace[node.id]
        raise ValueError(f"legacy .jl: name {node.id!r} not allowed")
    if isinstance(node, ast.Subscript):
        container = _safe_eval(node.value, namespace)
        key = _safe_eval(node.slice, namespace)
        return container[key]
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("_D", "_undef_dicts") and not node.keywords:
        fn = namespace[node.func.id]
        return fn(*[_safe_eval(a, namespace) for a in node.args])
    raise ValueError(
        f"legacy .jl: unsupported expression node {type(node).__name__}"
    )


def _julia_literal(expr: str, env: Dict[str, Any] = None):
    for pat, rep in _REPLACEMENTS:
        expr = pat.sub(rep, expr)
    namespace = {"_D": _dictcall, "_undef_dicts": _undef_dicts}
    if env:
        namespace.update(env)  # RHS may reference the dicts: 1 / md["MDsteps"]
    return _safe_eval(ast.parse(expr, mode="eval"), namespace)


# All legacy dicts the reference's include() environment provides
# (transform_oldinputfile.jl:111-118): system, md, actions, cg, wilson,
# staggered, measurement (+ defaultmeasures).  Optionally one level of
# 1-based array indexing on the value, as the examples use:
#     measurement["measurement_methods"][3]["mass"] = 1
_DICT_NAMES = ("system", "actions", "md", "measurement", "cg", "wilson",
               "staggered", "defaultmeasures")
_ASSIGN = re.compile(
    r'^(system|actions|md|measurement|cg|wilson|staggered|defaultmeasures)'
    r'\["([^"]+)"\](?:\[(\d+)\]\["([^"]+)"\])?\s*=\s*(.*)$'
)


def parse_legacy_jl(path: str) -> Dict[str, Dict[str, Any]]:
    """Parse the legacy dicts from a .jl parameter file.

    Defaults for the fermion/solver sub-dicts are pre-seeded exactly as
    the reference's defaults functions do (transform_oldinputfile.jl:
    default_wilson :92-98, default_staggered :100-104, default_cg
    :85-90), since old files may rely on them; system/md defaults are
    left to the Params dataclass downstream."""
    dicts: Dict[str, Dict[str, Any]] = {
        "system": {},
        "actions": {},
        "md": {},
        "measurement": {},
        "cg": {"eps": 1e-19, "MaxCGstep": 3000},
        "wilson": {"r": 1, "Clover_coefficient": 1.5612},
        "staggered": {"Nf": 4},
        "defaultmeasures": {},
    }
    with open(path) as fp:
        text = fp.read()
    # join continued lines: an assignment runs until brackets balance
    lines = text.split("\n")
    buf = ""
    target = None
    key = None
    idx = None
    subkey = None
    in_block_comment = False
    for line in lines:
        # Julia block comments #= ... =# (the examples wrap dead config
        # and digitized reference data in them)
        if in_block_comment:
            if "=#" in line:
                in_block_comment = False
            continue
        if not buf and line.lstrip().startswith("#="):
            if "=#" not in line:
                in_block_comment = True
            continue
        line = line.split("#")[0].rstrip() if not buf else line.rstrip()
        if not buf:
            m = _ASSIGN.match(line.strip())
            if not m:
                continue
            target, key, idx, subkey, rhs = m.groups()
            buf = rhs
        else:
            buf += " " + line.strip()
        if buf.count("(") == buf.count(")") and buf.count("[") == buf.count("]"):
            value = _julia_literal(buf.rstrip().rstrip(";"), env=dicts)
            if idx is not None:
                # 1-based indexed assignment into an array-of-dicts value
                dicts[target][key][int(idx) - 1][subkey] = value
            else:
                dicts[target][key] = value
            buf = ""
    return dicts


def _convert_measurement(method: Dict[str, Any]) -> Dict[str, Any]:
    """Old method dict -> new measurement_methods entry: fermiontype and
    fermion params move under fermion_parameters."""
    out = dict(method)
    ferm = out.pop("fermiontype", None)
    if ferm not in (None, "nothing"):
        fp = {"Dirac_operator": ferm}
        for k in ("mass", "Nf", "hop", "r", "BoundaryCondition", "M", "m", "L5"):
            if k in out:
                fp[k] = out.pop(k)
        out["fermion_parameters"] = fp
    return out


def legacy_jl_to_toml_dict(path: str) -> Dict[str, Any]:
    """Full conversion to the five-section TOML layout
    (transform_to_toml semantics)."""
    d = parse_legacy_jl(path)
    system = d["system"]
    md = d["md"]
    meas = d["measurement"]

    physical: Dict[str, Any] = {}
    fermions: Dict[str, Any] = {}
    control: Dict[str, Any] = {}
    hmc: Dict[str, Any] = {}

    phys_keys = {
        "L", "β", "NC", "Nthermalization", "Nsteps", "initial", "initialtrj",
        "update_method", "useOR", "numOR", "Nwing",
    }
    ferm_keys = {
        "quench", "Dirac_operator", "Clover_coefficient", "r", "hop", "Nf",
        "mass", "Domainwall_M", "Domainwall_m", "Domainwall_L5",
        "BoundaryCondition", "smearing_for_fermion", "stout_numlayers",
        "stout_ρ", "stout_loops",
    }
    for k, v in system.items():
        if k in phys_keys:
            physical[k] = list(v) if isinstance(v, tuple) else v
        elif k in ferm_keys:
            fermions[k] = v
        else:
            control[k] = v
    for k, v in md.items():
        hmc[k] = v
    # fermion/solver sub-dicts (include()-time dicts wilson/staggered/cg,
    # transform_oldinputfile.jl:116-117,85): fold into the fermion and
    # HMC sections under the modern key names
    dirac = fermions.get("Dirac_operator")
    if dirac in ("Wilson", "WilsonClover"):
        for k in ("hop", "r", "Clover_coefficient"):
            if k in d["wilson"]:
                fermions.setdefault(k, d["wilson"][k])
    elif dirac == "Staggered":
        for k in ("mass", "Nf"):
            if k in d["staggered"]:
                fermions.setdefault(k, d["staggered"][k])
    for old, new in (("eps", "eps"), ("MaxCGstep", "MaxCGstep")):
        if old in d["cg"]:
            hmc.setdefault(new, d["cg"][old])
    # old files say quench via system["quench"]; Dirac_operator None => quenched
    if fermions.get("Dirac_operator") is None:
        fermions["Dirac_operator"] = "nothing"
        fermions["quench"] = True

    methods = {}
    for m in meas.get("measurement_methods", []):
        mm = _convert_measurement(m)
        methods[mm["methodname"]] = mm
    out = {
        "Physical setting": physical,
        "Physical setting(fermions)": fermions,
        "System Control": control,
        "HMC related": hmc,
        "Measurement set": {
            "measurement_methods": methods,
            "measurement_dir": meas.get("measurement_dir", ""),
            "measurement_basedir": meas.get("measurement_basedir", ""),
        },
    }
    return out


def transform_to_toml(jl_path: str, toml_path: str = None) -> str:
    """Write the converted TOML next to the .jl file (lqcd.jl:51 flow)."""
    from latticeqcd_torch.system.wizard import write_toml

    data = legacy_jl_to_toml_dict(jl_path)
    if toml_path is None:
        toml_path = jl_path.rsplit(".", 1)[0] + ".toml"
    write_toml(data, toml_path)
    return toml_path

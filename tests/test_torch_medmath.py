"""Tasks 4 and 5 of the port (``core/medmath.py``) against the JAX
package's module, on the parts that do not depend on Python's salted
string hash.

The reference builds ``DISEASE_MAP`` and ``CONCENTRATIONS`` from
``hash(name)``, which changes with ``PYTHONHASHSEED`` from one process to
the next; the port derives them from ``zlib.crc32`` of the name, so its
tables are the same in every process. Held to the reference: the
division and its error, the edit-distance matcher over the reference's
noisy spellings and a seeded sweep of misspellings, the tables' keys and
cardinalities, the concentration range, and the dosage as quantity over
the label's concentration.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.core import medmath as J
from repro_torch.core import medmath as P

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.mark.parametrize("qty, conc", [(21.0, 4.2), (10.0, 0.5), (1.0, 8.4),
                                       (0.0, 3.0), (7.5, 1e-6)])
def test_med_math_matches_reference(qty, conc):
    assert P.med_math(qty, conc) == J.med_math(qty, conc)
    assert P.med_math(21.0, 4.2) == pytest.approx(5.0)


@pytest.mark.parametrize("conc", [0.0, -1.0])
def test_med_math_rejects_bad_concentration(conc):
    for mod in (J, P):
        with pytest.raises(ValueError, match="concentration must be positive"):
            mod.med_math(1.0, conc)


def test_ed_match_corrects_the_reference_spellings():
    for raw, want in (("nal0xone", "naloxone"), ("atrovnet", "atrovent"),
                      ("zzzzqqqq", None), ("naloxon", "naloxone"),
                      ("  ADRENALINE ", "adrenaline")):
        assert P.ed_match(raw) == J.ed_match(raw) == want


def _misspell(rng, name):
    """One to three edits: a substitution, a deletion, a doubled letter
    or a swap of neighbours."""
    s = list(name)
    for _ in range(int(rng.integers(1, 4))):
        i = int(rng.integers(0, len(s)))
        op = int(rng.integers(0, 4))
        if op == 0:
            s[i] = "abcdefghijklmnopqrstuvwxyz0"[int(rng.integers(0, 27))]
        elif op == 1 and len(s) > 3:
            del s[i]
        elif op == 2:
            s.insert(i, s[i])
        elif i + 1 < len(s):
            s[i], s[i + 1] = s[i + 1], s[i]
    return "".join(s)


def test_ed_match_sweep_matches_reference():
    rng = np.random.default_rng(0)
    hits = 0
    for name in P.MEDICINES * 12:
        raw = _misspell(rng, name)
        got = P.ed_match(raw)
        assert got == J.ed_match(raw), raw
        hits += got == name
    assert hits > 0.8 * 12 * len(P.MEDICINES)
    for cutoff in (0.2, 0.6, 0.9):
        assert P.ed_match("adrenalin", cutoff=cutoff) == \
            J.ed_match("adrenalin", cutoff=cutoff)


def test_tables_keys_and_cardinalities_match_reference():
    assert P.MEDICINES == J.MEDICINES and len(P.MEDICINES) == 18
    assert P.N_DISEASES == J.N_DISEASES == 82
    for mod in (J, P):
        assert set(mod.DISEASE_MAP) == set(mod.MEDICINES)
        assert set(mod.CONCENTRATIONS) == set(mod.MEDICINES)
        for m, ds in mod.DISEASE_MAP.items():
            assert len(ds) == 3 and ds == sorted(ds)
            assert all(0 <= d < mod.N_DISEASES for d in ds)
            # three consecutive diseases, mod N_DISEASES
            assert sorted((d - ds[0]) % mod.N_DISEASES for d in ds) in (
                [0, 1, 2], [0, 1, 81], [0, 80, 81])
        for c in mod.CONCENTRATIONS.values():
            assert 0.5 <= c <= 8.4 and c == round(c, 1)


@pytest.mark.parametrize("qty, text", [(10.0, "naloxon"),
                                       (21.0, "adrenaline"),
                                       (2.5, "fentanil"), (1.0, "zzzzqqqq")])
def test_dosage_from_label_matches_reference_rule(qty, text):
    got, want = P.dosage_from_label(qty, text), J.dosage_from_label(qty, text)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got["medicine"] == want["medicine"]
    m = got["medicine"]
    assert got["concentration_mg_per_ml"] == P.CONCENTRATIONS[m]
    assert got["dosage_ml"] == qty / P.CONCENTRATIONS[m]
    assert got["disease_history"] == P.DISEASE_MAP[m]
    assert P.disease_history(text) == P.DISEASE_MAP[m]
    assert P.disease_history("zzzzqqqq") == J.disease_history("zzzzqqqq") == []


def _tables(seed):
    code = ("import json; from repro_torch.core import medmath as M; "
            "print(json.dumps([M.DISEASE_MAP, M.CONCENTRATIONS]))")
    env = dict(os.environ, PYTHONHASHSEED=str(seed), PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    return json.loads(out.stdout)


def test_tables_are_the_same_in_every_process():
    a, b = _tables(1), _tables(2)
    assert a == b
    assert a == json.loads(json.dumps([P.DISEASE_MAP, P.CONCENTRATIONS]))

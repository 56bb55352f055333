"""Tasks 4 & 5: med-math dosage and disease-history inference.

Task 4 (paper §3.4): dosage = prescribed quantity / label concentration
— "a division operator" fed by header-3 output and the OCR/barcode
concentration. Task 5: medicine name -> disease history via a dictionary
of 82 common EMS diseases (synthetic stand-in table with the same
cardinality).

The synthetic tables derive from a stable digest of each medicine's name
(``zlib.crc32``), so a medicine's diseases and label concentration are the
same in every process. Python's ``hash`` of a string is salted per
process and would change them from run to run.
"""
from __future__ import annotations

import difflib
import zlib

N_DISEASES = 82

# synthetic stand-ins with the paper's cardinalities (18 medicines)
MEDICINES = [
    "adrenaline", "atrovent", "naloxone", "aspirin", "nitroglycerin",
    "albuterol", "epinephrine", "glucagon", "morphine", "fentanyl",
    "midazolam", "diazepam", "amiodarone", "lidocaine", "atropine",
    "dextrose", "ondansetron", "diphenhydramine",
]


def _digest(name: str) -> int:
    return zlib.crc32(name.encode("utf-8"))


DISEASE_MAP = {m: sorted((_digest(m) + i) % N_DISEASES for i in range(3))
               for m in MEDICINES}

CONCENTRATIONS = {m: round(0.5 + (_digest(m) % 80) / 10.0, 1)
                  for m in MEDICINES}


def med_math(quantity_mg: float, concentration_mg_per_ml: float) -> float:
    """Paper example: 21 mg of Adrenaline at 4.2 mg/ml -> 5 ml."""
    if concentration_mg_per_ml <= 0:
        raise ValueError("concentration must be positive")
    return quantity_mg / concentration_mg_per_ml


def ed_match(raw: str, candidates=MEDICINES, cutoff: float = 0.4):
    """Edit-distance matching of noisy OCR output to the true medicine
    list (paper Fig. 6 'ED-Match'). Returns best candidate or None."""
    hits = difflib.get_close_matches(raw.lower().strip(), candidates,
                                     n=1, cutoff=cutoff)
    return hits[0] if hits else None


def disease_history(medicine_name: str):
    m = ed_match(medicine_name)
    if m is None:
        return []
    return DISEASE_MAP[m]


def dosage_from_label(quantity_mg: float, ocr_text: str):
    """End of the image pipeline: OCR text -> medicine + concentration ->
    dosage (task 4) + disease history (task 5)."""
    m = ed_match(ocr_text)
    if m is None:
        return None
    conc = CONCENTRATIONS[m]
    return {
        "medicine": m,
        "concentration_mg_per_ml": conc,
        "dosage_ml": med_math(quantity_mg, conc),
        "disease_history": DISEASE_MAP[m],
    }

"""CABAC context model layout + initialization values.

The flat context buffer layout mirrors the syntax-element grouping of the
reference (source/common/contexts.h offsets); the initialization values are
the normative spec tables (Rec. H.265 Tables 9-5..9-32; cross-checked
against reference entropy.cpp:42-225 INIT_* arrays).  Init arrays are
indexed [init_type][ctx] with init_type B=0, P=1, I=2.
"""
from __future__ import annotations

import numpy as np

from .cabac import init_context

CNU = 154  # 'context not used' placeholder

# --- context counts per group ------------------------------------------------
NUM_SPLIT_FLAG = 3
NUM_SKIP_FLAG = 3
NUM_MERGE_FLAG = 1
NUM_MERGE_IDX = 1
NUM_PART_SIZE = 4
NUM_PRED_MODE = 1
NUM_ADI = 1
NUM_CHROMA_PRED = 2
NUM_DELTA_QP = 3
NUM_INTER_DIR = 5
NUM_REF_NO = 2
NUM_MV_RES = 2
NUM_QT_CBF = 7
NUM_TRANS_SUBDIV = 3
NUM_QT_ROOT_CBF = 1
NUM_SIG_CG = 4            # 2 luma + 2 chroma
NUM_SIG = 42              # 27 luma + 15 chroma
NUM_LAST_XY = 18          # 15 luma + 3 chroma, for each of X and Y
NUM_ONE = 24              # 16 luma + 8 chroma
NUM_ABS = 6               # 4 luma + 2 chroma
NUM_MVP_IDX = 1
NUM_SAO_MERGE = 1
NUM_SAO_TYPE = 1
NUM_TSKIP = 2
NUM_TQ_BYPASS = 1

_order = [
    ("SPLIT_FLAG", NUM_SPLIT_FLAG), ("SKIP_FLAG", NUM_SKIP_FLAG),
    ("MERGE_FLAG", NUM_MERGE_FLAG), ("MERGE_IDX", NUM_MERGE_IDX),
    ("PART_SIZE", NUM_PART_SIZE), ("PRED_MODE", NUM_PRED_MODE),
    ("ADI", NUM_ADI), ("CHROMA_PRED", NUM_CHROMA_PRED),
    ("DELTA_QP", NUM_DELTA_QP), ("INTER_DIR", NUM_INTER_DIR),
    ("REF_NO", NUM_REF_NO), ("MV_RES", NUM_MV_RES),
    ("QT_CBF", NUM_QT_CBF), ("TRANS_SUBDIV", NUM_TRANS_SUBDIV),
    ("QT_ROOT_CBF", NUM_QT_ROOT_CBF), ("SIG_CG", NUM_SIG_CG),
    ("SIG", NUM_SIG), ("LAST_X", NUM_LAST_XY), ("LAST_Y", NUM_LAST_XY),
    ("ONE", NUM_ONE), ("ABS", NUM_ABS), ("MVP_IDX", NUM_MVP_IDX),
    ("SAO_MERGE", NUM_SAO_MERGE), ("SAO_TYPE", NUM_SAO_TYPE),
    ("TSKIP", NUM_TSKIP), ("TQ_BYPASS", NUM_TQ_BYPASS),
]

OFF = {}
_cursor = 0
for _name, _n in _order:
    OFF[_name] = _cursor
    _cursor += _n
NUM_CONTEXTS = _cursor


# --- normative init values, [B, P, I] ---------------------------------------
INIT_VALUES: dict = {
    "SPLIT_FLAG": [[107, 139, 126], [107, 139, 126], [139, 141, 157]],
    "SKIP_FLAG": [[197, 185, 201], [197, 185, 201], [CNU, CNU, CNU]],
    "MERGE_FLAG": [[154], [110], [CNU]],
    "MERGE_IDX": [[137], [122], [CNU]],
    "PART_SIZE": [[154, 139, 154, 154], [154, 139, 154, 154],
                  [184, CNU, CNU, CNU]],
    "PRED_MODE": [[134], [149], [CNU]],
    "ADI": [[183], [154], [184]],
    "CHROMA_PRED": [[152, 139], [152, 139], [63, 139]],
    "DELTA_QP": [[154, 154, 154]] * 3,
    "INTER_DIR": [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31],
                  [CNU, CNU, CNU, CNU, CNU]],
    "REF_NO": [[153, 153], [153, 153], [CNU, CNU]],
    "MV_RES": [[169, 198], [140, 198], [CNU, CNU]],
    "QT_CBF": [[153, 111, 149, 92, 167, 154, 154],
               [153, 111, 149, 107, 167, 154, 154],
               [111, 141, 94, 138, 182, 154, 154]],
    "TRANS_SUBDIV": [[224, 167, 122], [124, 138, 94], [153, 138, 138]],
    "QT_ROOT_CBF": [[79], [79], [CNU]],
    "SIG_CG": [[121, 140, 61, 154], [121, 140, 61, 154],
               [91, 171, 134, 141]],
    "SIG": [
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
         151, 183, 140],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
         151, 183, 140],
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
         153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
         125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
         136, 139, 111],
    ],
    "LAST_X": [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
         111, 79, 108, 123, 93],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108],
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63],
    ],
    "ONE": [
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
         107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
    ],
    "ABS": [[107, 167, 91, 107, 107, 167], [107, 167, 91, 122, 107, 167],
            [138, 153, 136, 167, 152, 152]],
    "MVP_IDX": [[168], [168], [CNU]],
    "SAO_MERGE": [[153], [153], [153]],
    "SAO_TYPE": [[160], [185], [200]],
    "TSKIP": [[139, 139]] * 3,
    "TQ_BYPASS": [[154], [154], [154]],
}
INIT_VALUES["LAST_Y"] = INIT_VALUES["LAST_X"]


def init_states(slice_type: int, qp: int) -> np.ndarray:
    """Build the full packed-state context array for a slice.

    slice_type: 0=B, 1=P, 2=I (init_type equals slice type; cabac_init_flag
    swapping is not used).
    """
    states = np.zeros(NUM_CONTEXTS, dtype=np.uint8)
    for name, n in _order:
        vals = INIT_VALUES[name][slice_type]
        off = OFF[name]
        for i in range(n):
            states[off + i] = init_context(qp, vals[i])
    return states

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PERFBENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(PERFBENCH)
for p in (HERE, PERFBENCH, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

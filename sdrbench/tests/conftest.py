"""The benchmark's own tests (CPU): python -m pytest sdrbench/tests -q"""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import os.path as osp
import sys

# the checkout's root, so that `benchmark` and the program import
ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

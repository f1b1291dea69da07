"""``calibrate.py`` with the MLA/MoE program's own faults as well.

    python3 perfbench/calibrate_moe.py --workload <cell> --seeds 1 2 3 \
        [--window 51] [--control] [--fault v2_router|no_mscale|...] \
        [--witness]

Adds the faults of ``lib/faults_moe.py`` to those ``lib/faults.py``
plants and runs ``calibrate.main`` (its docstring says the rest).
``--witness`` sets the generator's ``witness``: its ``worst_leaf`` then
also gives the gaps with the reference's router held to the program's
expert ids (``generators/serve_moe.py``).
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import calibrate
    from perfbench.lib import faults, faults_moe, runner
    faults.SITES.update(faults_moe.SITES)
    if "--witness" in sys.argv:
        sys.argv.remove("--witness")
        make = runner.make_traffic

        def make_traffic(*args, **kw):
            cell, traffic = make(*args, **kw)
            traffic.witness = True
            return cell, traffic
        runner.make_traffic = make_traffic
    sys.exit(calibrate.main())

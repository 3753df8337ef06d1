#!/usr/bin/env python3
"""Run chip_smoke.py from a checkout, with every fit's final theta recorded.

    python3 chip_ab.py [CHECKOUT]      (default: this script's directory)

Imports CHECKOUT's chip_smoke.py and gmeta_tpu_torch (CHECKOUT first on
sys.path and the working directory), wraps Trainer.fit and
EdgePartTrainer.fit so that each fit that returns records its class, data
directory, global step and a sha256 of its theta's bytes, and runs
chip_smoke's main(). After chip_smoke's own output it prints one line,
{"theta_digests": [...]}, in the order the fits ended. Run on two
checkouts (a parent and a change) in one call, in turns: equal digests of
the same fits mean bitwise-equal theta. The rank processes of phase 10(c)
are not wrapped. Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import chip_smoke
    from gmeta_tpu_torch.run import edgepart, train
    digests = []

    def record(cls, params_of):
        fit = cls.fit

        def recorded(self):
            result = fit(self)
            h = hashlib.sha256()
            for p in params_of(self):
                h.update(p.detach().cpu().numpy().tobytes())
            digests.append({"fit": cls.__name__,
                            "data": os.path.basename(self.cfg.data_dir),
                            "step": int(result.global_step),
                            "sha256": h.hexdigest()})
            return result
        cls.fit = recorded

    record(train.Trainer, lambda t: t.learner.params)
    record(edgepart.EdgePartTrainer, lambda t: t.engine.params)
    chip_smoke.main()
    print(json.dumps({"theta_digests": digests}), flush=True)


if __name__ == "__main__":
    main()

"""dssm_tpu's C++ host extension (native/dssm_native.cpp), built whole
before any test of the port reads it.

dssm_tpu/data/native.py builds the extension on first use with `g++ ... -o
<so>` straight into native/build/ and loads any file there that is newer
than the source. Two test processes that start on a clean checkout at once
race: one links the file while the other finds it, still short, and its
load fails ("file too short"). build() links into a file of its own and
renames it into place, under a lock, so that every process that has called
it finds either no file or a whole one that dssm_tpu's loader then takes as
it is. tests/test_torch_models.py and test_torch_data.py call it when
they are imported: pytest imports every test module in every worker before
any test runs, so the first call links the file and the others wait for it.
"""

import fcntl
import os
import subprocess
import sysconfig

from dssm_tpu.data import native


def build() -> None:
    """native._so_path() linked whole, unless a file newer than the source
    is already there."""
    so = native._so_path()
    os.makedirs(os.path.dirname(so), exist_ok=True)
    with open(os.path.join(os.path.dirname(so), ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(native._SRC)):
            return
        tmp = f"{so}.{os.getpid()}.tmp"
        # dssm_tpu's own command (native._build), into a file of this
        # process's.
        subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                        f"-I{sysconfig.get_paths()['include']}", native._SRC,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, so)

"""Build and run the port's C ABI: the shim `libcpcodec.so` (cpcodec.cpp,
which embeds CPython and imports `pcodec_tpu_torch.capi`) and its C test
program (test_cpcodec.c), built with g++/gcc into a directory the caller
names (the repository's `build/` is ignored by git).

    python_headers()        Python.h's directory, or an error naming it
    build_shim(out, embed)  libcpcodec.so; embed=True links libpython (a
                            C program's interpreter), embed=False leaves
                            the Python symbols to the loading process (a
                            Python process that loads it with ctypes)
    load_shim(so)           a shim built with embed=False, loaded into this
                            process with its C signatures declared
    build_test_program(out, shim_dir)
    run_test_program(exe)   the program with the port on PYTHONPATH

The shim's decode runs on the card, so the test program passes only where
a CUDA device is.
"""

import ctypes
import os
import subprocess
import sys
import sysconfig

NATIVE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(NATIVE))


def python_headers() -> str:
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"Python.h is not in {inc}: the C ABI's shim embeds CPython and needs its headers")
    return inc


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stdout}{proc.stderr}")


def build_shim(out_dir: str, embed: bool = True) -> str:
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libcpcodec.so" if embed else "libcpcodec_inprocess.so")
    cmd = ["g++", "-O2", "-shared", "-fPIC", os.path.join(NATIVE, "cpcodec.cpp"), f"-I{python_headers()}",
           "-o", so]
    if embed:
        pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
        cmd += [f"-L{sysconfig.get_config_var('LIBDIR')}", f"-l{pyver}", "-ldl", "-lm"]
    _run(cmd)
    return so


def load_shim(so: str) -> ctypes.CDLL:
    """The shim loaded into this process (its Python symbols resolve to
    this interpreter's), with cpcodec.h's signatures declared."""
    lib = ctypes.CDLL(so)
    size_p = ctypes.POINTER(ctypes.c_size_t)
    lib.pco_standalone_guarantee_file_size.argtypes = [ctypes.c_ubyte, ctypes.c_size_t]
    lib.pco_standalone_guarantee_file_size.restype = ctypes.c_size_t
    lib.pco_standalone_simple_compress_into.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_ubyte, ctypes.c_uint,
                                                        ctypes.c_void_p, ctypes.c_size_t, size_p]
    lib.pco_standalone_simple_compress_into.restype = ctypes.c_int
    lib.pco_standalone_simple_decompress_into.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_ubyte,
                                                          ctypes.c_void_p, ctypes.c_size_t, size_p]
    lib.pco_standalone_simple_decompress_into.restype = ctypes.c_int
    return lib


def build_test_program(out_dir: str, shim_dir: str) -> str:
    exe = os.path.join(out_dir, "test_cpcodec")
    _run(["gcc", os.path.join(NATIVE, "test_cpcodec.c"), f"-L{shim_dir}", "-lcpcodec", f"-Wl,-rpath,{shim_dir}",
          f"-I{NATIVE}", "-o", exe])
    return exe


def run_test_program(exe: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """The test program with the repository and this Python's
    site-packages on PYTHONPATH (the embedded interpreter's path)."""
    env = dict(os.environ)
    paths = [REPO] + [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = os.pathsep.join(paths + [env["PYTHONPATH"]] if env.get("PYTHONPATH") else paths)
    return subprocess.run([exe], env=env, capture_output=True, text=True, timeout=timeout)

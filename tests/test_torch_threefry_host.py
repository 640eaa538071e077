"""The threefry kernel's index and bit logic on the CPU.

``csrc/threefry.cu`` is compiled for the host with g++ against a small
stand-in for the CUDA runtime (each launch a loop over its blocks and
threads, the intrinsics their IEEE equivalents) and bound in place of the
card's library.  The public draws then take the kernel route on CPU keys,
through the wrapper's checks, strides and broadcasting, and are held
against the plain route.  Skips without g++.  The card's own build is held
bitwise by ``tests/test_torch_threefry_card.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from icassp2022_depression_tpu_torch._build import CSRC
from icassp2022_depression_tpu_torch.ops import prng

#: what the kernel source takes from ``cuda_runtime.h``, for the host
RUNTIME = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 blockIdx, threadIdx, gridDim;
struct uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
struct longlong2 { long long x, y; };
inline longlong2 make_longlong2(long long a, long long b) { return {a, b}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)(((((uint64_t)hi << 32) | lo) << (s & 31)) >> 32);
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline float __double2float_rn(double a) { return (float)a; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class K, class A>
void launch_on_host(K kernel, dim3 grid, unsigned threads, const A& a) {
  gridDim = grid;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x = 0; x < grid.x; ++x)
      for (unsigned t = 0; t < threads; ++t) {
        blockIdx = dim3(x, y);
        threadIdx = dim3(t);
        kernel(a);
      }
}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ unavailable: the host build of the kernel is skipped")
    work = tmp_path_factory.mktemp("threefry_host")
    (work / "cuda_runtime.h").write_text(RUNTIME)
    src, launches = re.subn(
        r"(threefry_kernel<M, (?:true|false)>)<<<grid, kThreads, 0, s>>>"
        r"\(a\);", r"launch_on_host(\1, grid, kThreads, a);",
        (CSRC / "threefry.cu").read_text())
    assert launches == 2
    (work / "threefry_host.cpp").write_text(src)
    so = work / "libthreefry_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(work), "-o", str(so),
                    str(work / "threefry_host.cpp")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).threefry_draw
    fn.argtypes, fn.restype = prng._ARGTYPES, ctypes.c_int
    return fn


@pytest.fixture
def kernel_route(host_build, monkeypatch):
    """The public draws take the kernel route on CPU keys and launch the
    host build."""
    check = prng._check_key

    def check_but_the_device(key):
        try:
            check(key)
        except ValueError as e:
            if "device" not in str(e):
                raise

    monkeypatch.setattr(prng, "_fn", host_build)
    monkeypatch.setattr(prng, "_on_card", lambda key: True)
    monkeypatch.setattr(prng, "_check_key", check_but_the_device)
    monkeypatch.setattr(prng, "LAUNCHES", 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: -1)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda device: 0, raising=False)


def _keys(rows):
    return prng.split_torch(prng.prng_key(23), rows)          # [rows, 2]


#: (draws on the kernel route, the plain route, launches), on [3, 2] keys:
#: each layout of keys and data the wrapper reads by strides or copies
CASES = {
    "fold_in int": (lambda k: prng.fold_in(k, 7),
                    lambda k: prng.fold_in_torch(k, 7), 1),
    "fold_in negative int": (lambda k: prng.fold_in(k[0], -1),
                             lambda k: prng.fold_in_torch(k[0], -1), 1),
    "fold_in ordinals of one key": (
        lambda k: prng.fold_in(k[0], torch.arange(96)),
        lambda k: prng.fold_in_torch(k[0], torch.arange(96)), 1),
    "fold_in a key a row": (
        lambda k: prng.fold_in(k, torch.tensor([4, 5, 6])),
        lambda k: prng.fold_in_torch(k, torch.tensor([4, 5, 6])), 1),
    "fold_in 0-dim data": (lambda k: prng.fold_in(k, torch.tensor(11)),
                           lambda k: prng.fold_in_torch(k, torch.tensor(11)),
                           1),
    "fold_in strided data": (
        lambda k: prng.fold_in(k[0], torch.arange(10)[::2]),
        lambda k: prng.fold_in_torch(k[0], torch.arange(10)[::2]), 1),
    "fold_in broadcast [3, 1] x [4]": (
        lambda k: prng.fold_in(k[:, None], torch.arange(4)),
        lambda k: prng.fold_in_torch(k[:, None], torch.arange(4)), 1),
    "split 4": (lambda k: prng.split(k, 4),
                lambda k: prng.split_torch(k, 4), 1),
    "split2 of a split2 half": (
        lambda k: prng.split2(prng.split2(k)[1]),
        lambda k: tuple(prng.split_torch(prng.split_torch(k)[:, 1], 2)
                        .unbind(-2)), 2),
    "random_bits odd rows": (
        lambda k: prng.random_bits(k, (5, 7), rows=(2, 9)),
        lambda k: prng.random_bits_torch(k, (5, 7), rows=(2, 9)), 1),
    "random_bits even": (lambda k: prng.random_bits(k, (1000,)),
                         lambda k: prng.random_bits_torch(k, (1000,)), 1),
    "uniform [0, 1)": (lambda k: prng.uniform(k, (64, 3)),
                       lambda k: prng.uniform_torch(k, (64, 3)), 1),
    "uniform a power-of-two span": (
        lambda k: prng.uniform(k, (4, 257), -0.0625, 0.0625),
        lambda k: prng.uniform_torch(k, (4, 257), -0.0625, 0.0625), 1),
    "uniform another span, ragged": (
        lambda k: prng.uniform(k, (1030,), -0.3, 0.3),
        lambda k: prng.uniform_torch(k, (1030,), -0.3, 0.3), 1),
    "bernoulli rows": (
        lambda k: prng.bernoulli(k, 0.5, (4, 256), (4, 8)),
        lambda k: prng.bernoulli_torch(k, 0.5, (4, 256), (4, 8)), 1),
    "bernoulli ragged": (lambda k: prng.bernoulli(k, 0.7, (5, 3)),
                         lambda k: prng.bernoulli_torch(k, 0.7, (5, 3)), 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_build_matches_plain_route(case, kernel_route):
    """Keys, bits, uniforms and masks bit for bit, one launch a draw."""
    kernel, plain, launches = CASES[case]
    keys = _keys(3)
    got, want = kernel(keys), plain(keys)
    assert prng.LAUNCHES == launches
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def test_host_build_normals_close(kernel_route):
    """Normals through the same transforms: within 1e-6 here, because the
    CPU's ``torch.log1p`` and ``torch.sqrt`` are not g++'s ``log1pf`` and
    ``sqrtf`` in the last bit (on the card both routes use CUDA's, and
    agree bitwise); their uniforms are exact above."""
    keys = _keys(3)
    got = prng.normal(keys, (1280, 16))
    assert prng.LAUNCHES == 1
    torch.testing.assert_close(got, prng.normal_torch(keys, (1280, 16)),
                               rtol=0, atol=1e-6)

"""The kernel build refuses a library whose warp-specialized kernels did
not get the registers their setmaxnreg hand-off needs (ops/cuda/build.py).
CPU only: the check reads nvcc's ``-Xptxas -v`` output."""

import pytest

from dlrover_tpu_torch.ops.cuda import build

_ENTRY = ("ptxas info    : Compiling entry function '_ZN5flash{name}' for "
          "'sm_90a'\n"
          "ptxas info    : Function properties for _ZN5flash{name}\n"
          "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
          "loads\n"
          "ptxas info    : Used {regs} registers, used 1 barriers\n")

#: mangled names of the library's kernels, as ptxas prints them
KERNELS = {
    "fwd64": "10fwd_kernelILi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16",
    "fwd128": "10fwd_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16",
    "dq64": "9dq_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13",
    "dq128": "9dq_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13",
    "dkv64": "10dkv_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13",
    "dkv128": "10dkv_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13",
    "sum": "13dkv_sum_partsEPKfP13__nv_bfloat16S3_lif",
}
#: what ptxas reported on the H100 build: the summing pass is not
#: warp-specialized and may use any count
SOUND = {"fwd64": 168, "fwd128": 168, "dq64": 168, "dq128": 168,
         "dkv64": 168, "dkv128": 168, "sum": 40}


def _log(regs):
    return "".join(_ENTRY.format(name=KERNELS[k], regs=r)
                   for k, r in regs.items())


def test_sound_build_passes():
    build.check_registers(_log(SOUND))


@pytest.mark.parametrize(
    "kernel", ["fwd64", "fwd128", "dq64", "dq128", "dkv64", "dkv128"])
def test_fewer_registers_are_refused(kernel):
    with pytest.raises(RuntimeError, match="168 registers"):
        build.check_registers(_log({**SOUND, kernel: 160}))


def test_a_log_without_the_kernels_is_refused():
    with pytest.raises(RuntimeError, match="no register count"):
        build.check_registers(_log({"dq64": 166, "sum": 40}))


def test_a_log_without_the_dq_kernel_is_refused():
    log = _log({k: r for k, r in SOUND.items() if not k.startswith("dq")})
    with pytest.raises(RuntimeError, match="dq_kernel"):
        build.check_registers(log)

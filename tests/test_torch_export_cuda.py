"""The serving flash forward's custom op and the deployment export on the
card. Skips without a GPU. Imports no jax, so on a machine without jax it
runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_export_cuda.py -q

``vcd::flash_attention_fwd`` passes ``torch.library.opcheck`` on CUDA
tensors, bf16 and fp32; a 128-channel two-level model exported at 128px
(4096 mid-block tokens) launches ``flash_attention_fwd`` (bf16) or
``flash_attention_fwd_f32`` (fp32) twice a ``reconstruct``, as the live
wrapper does, and its ``reconstruct`` is within the export check's bound of
the live wrapper's (1e-4 at fp32 with TF32 off; at bf16 the live path's own
bf16-vs-fp32 difference).
"""

import pytest
import torch

from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
from vae_channel_dynamics_tpu_torch.tools import export_model

pytestmark = pytest.mark.cuda

FLASH_SHAPED = dict(block_out_channels=(32, 128), layers_per_block=1,
                    norm_num_groups=8, latent_channels=4, sample_size=128)
RES = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_opcheck_on_cuda(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 256, 128, generator=gen, device=cuda).to(dtype) for _ in range(3))
    before = dict(fa.launches)
    torch.library.opcheck(torch.ops.vcd.flash_attention_fwd.default, (q, k, v, 0.125, dtype))
    name = "flash_attention_fwd_f32" if dtype == torch.float32 else "flash_attention_fwd"
    assert fa.launches[name] > before[name]


@pytest.mark.parametrize("dtype_name,kernel", [("bf16", "flash_attention_fwd"),
                                               ("fp32", "flash_attention_fwd_f32")])
def test_exported_program_launches_the_flash_kernel(cuda, tmp_path, dtype_name, kernel):
    cfg = VAEConfig(**FLASH_SHAPED)
    model = AutoencoderKL(cfg)
    model.init_weights(torch.Generator().manual_seed(3))
    model_dir, dst = str(tmp_path / "model"), str(tmp_path / "exported")
    model_io.save_model_dir(model_dir, cfg, model.state_dict())
    manifest = export_model.export_model_dir(model_dir, dst, resolution=RES,
                                             dtype_name=dtype_name, device="cuda")
    assert manifest["attention_impl"] == "flash" and manifest["device"] == "cuda"
    assert all(info["vcd_ops"] == ["vcd::flash_attention_fwd"]
               for info in manifest["entry_points"].values())

    _, state = model_io.load_model_dir(model_dir)
    exported = export_model.ExportedVAEWrapper(dst, state)
    live = SDXLVAEWrapper(cfg, state_dict=state, dtype=exported.dtype, attn_impl="flash",
                          device=cuda)
    x = torch.rand((2, RES, RES, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    x = x.to(exported.dtype).float()
    counts = []
    for run in (exported, live):
        for name in fa.launches:
            fa.launches[name] = 0
        run.forward(x, sample_posterior=False)
        torch.cuda.synchronize()
        counts.append(dict(fa.launches))
    assert counts[0][kernel] == counts[1][kernel] == 2
    assert sum(counts[0].values()) == 2

    result = export_model.check_export(model_dir, dst, device="cuda")
    assert result["err"] <= result["bound"], result

"""The port stands alone: no module of `src/repro_torch/` imports JAX or
anything of the reference package `repro`, and its entry points run on
the GPU unless the caller asks for the CPU — with no GPU they raise
instead of falling back."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """Torch on one thread: the suite runs files in parallel workers."""
  n = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(n)


PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _imported_modules(path: Path):
  for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module


def test_port_imports_neither_jax_nor_reference():
  files = sorted(PORT.rglob("*.py"))
  assert len(files) > 20
  names = {str(f.relative_to(PORT)) for f in files}
  assert {"models/ctc.py", "core/tracenorm.py", "core/svd.py",
          "core/schedule.py", "optim/adamw.py", "training/trainer.py",
          "checkpoint/manager.py", "runtime/supervisor.py",
          "launch/train.py", "serving/speculative.py",
          "serving/engine.py", "models/api.py", "launch/serve.py",
          "models/whisper.py", "configs/whisper_small.py", "quant/ptq.py",
          "layers/norms.py", "layers/ffn.py", "layers/attention.py",
          "kernels/dispatch.py", "layers/mla.py", "layers/moe.py",
          "configs/deepseek_v2_lite.py",
          "configs/deepseek_v3_671b.py"} <= names
  bad = [(f.relative_to(PORT), mod) for f in files
         for mod in _imported_modules(f)
         if mod.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
  assert bad == []


def test_entry_points_default_to_the_gpu(monkeypatch):
  """With no GPU, a call that does not ask for the CPU raises."""
  from repro_torch import configs
  from repro_torch.device import resolve_device
  from repro_torch.models.deepspeech import init_decode_state, init_model
  from repro_torch.serving import StreamingSpeechServer
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = configs.get_smoke("deepspeech2-wsj")
  gen = torch.Generator().manual_seed(0)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    resolve_device()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_model(cfg, generator=gen)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_decode_state(cfg, 2)
  params = init_model(cfg, generator=gen, device="cpu")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    StreamingSpeechServer(cfg, params, batch_size=2)
  srv = StreamingSpeechServer(cfg, params, batch_size=2, device="cpu")
  assert srv.device.type == "cpu"


def test_lm_entry_points_default_to_the_gpu(monkeypatch):
  """The LM entry points too: with no GPU, not asking for the CPU
  raises."""
  from repro_torch import configs
  from repro_torch.models.transformer import init_decode_state, init_lm
  from repro_torch.serving import LMEngine
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = configs.get_smoke("llama3-8b")
  gen = torch.Generator().manual_seed(0)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_lm(cfg, generator=gen)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_decode_state(cfg, 2, 16)
  params = init_lm(cfg, generator=gen, device="cpu")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    LMEngine(cfg, params, batch_size=2, max_len=16)
  eng = LMEngine(cfg, params, batch_size=2, max_len=16, device="cpu")
  assert eng.device.type == "cpu"


def test_training_entry_points_default_to_the_gpu(monkeypatch, capsys):
  """`Trainer` and `launch.train` run on the GPU unless asked for the
  CPU; with no GPU they raise. On the CPU the launcher trains the DS2
  smoke model through both stages and a transformer's; a family without
  a port (xlstm) and a mesh are not ported yet and say so."""
  from repro_torch import configs
  from repro_torch.launch import train
  from repro_torch.training import TrainConfig, Trainer
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = configs.get_smoke("deepspeech2-wsj")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    Trainer(cfg, TrainConfig())
  with pytest.raises(RuntimeError, match="device='cpu'"):
    train.main(["--arch", "deepspeech2-wsj", "--steps", "1"])
  with pytest.raises(NotImplementedError, match="Distribution"):
    Trainer(cfg, TrainConfig(), mesh=object(), device="cpu")
  with pytest.raises(ValueError, match="not ported yet"):
    Trainer(cfg.with_(family="xlstm"), TrainConfig(), device="cpu")
  lm_out = train.main(["--arch", "llama3-8b", "--device", "cpu", "--steps",
                       "1", "--batch", "2", "--seq", "8"])
  assert lm_out["final_loss"] > 0
  out = train.main(["--arch", "deepspeech2-wsj", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--two-stage",
                    "--transition", "2"])
  assert out["final_loss"] > 0
  assert "stage 2" in capsys.readouterr().out


def test_whisper_entry_points_default_to_the_gpu(monkeypatch):
  """Whisper's entry points too: with no GPU, not asking for the CPU
  raises; `launch.train --arch whisper-small --device cpu` trains."""
  from repro_torch import configs
  from repro_torch.launch import train
  from repro_torch.models.whisper import init_decode_state, init_model
  from repro_torch.training import TrainConfig, Trainer
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = configs.get_smoke("whisper-small")
  gen = torch.Generator().manual_seed(0)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_model(cfg, generator=gen)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_decode_state(cfg, 2, 16, enc_len=8)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    Trainer(cfg, TrainConfig())
  assert init_model(cfg, generator=gen, device="cpu").pos_dec.device.type \
      == "cpu"
  out = train.main(["--arch", "whisper-small", "--device", "cpu", "--steps",
                    "1", "--batch", "2", "--seq", "16"])
  assert out["final_loss"] > 0


def test_deepseek_entry_points_default_to_the_gpu(monkeypatch):
  """The DeepSeek configs through the same entry points: with no GPU, not
  asking for the CPU raises; on the CPU the model (MLA, MoE, MTP head)
  and its latent decode state are built there."""
  from repro_torch import configs
  from repro_torch.models.transformer import init_decode_state, init_lm
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  cfg = configs.get_smoke("deepseek-v3-671b")
  gen = torch.Generator().manual_seed(0)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_lm(cfg, generator=gen)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    init_decode_state(cfg, 2, 16)
  params = init_lm(cfg, generator=gen, device="cpu")
  assert params.mtp.norm.device.type == "cpu"
  assert params.moe_layers.moe.router.dtype == torch.float32
  state = init_decode_state(cfg, 2, 16, device="cpu")
  assert state["moe"]["c_kv"].shape == (3, 2, 16, 32)

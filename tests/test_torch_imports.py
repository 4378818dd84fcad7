"""stt_tpu_torch and chip_smoke.py import no JAX and nothing of stt_tpu
(nor TensorFlow on import), the port's native libraries load nothing of
stt_tpu, and the port's entry points refuse to run on the CPU unless asked
to."""

import ast
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT, **env},
    )


def test_every_module_imports_without_jax_or_stt_tpu():
    proc = run("""
        import importlib, pkgutil, sys
        import stt_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(stt_tpu_torch.__path__, "stt_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "stt_tpu")]
        assert not bad, bad
        training = {"stt_tpu_torch.ctc.loss", "stt_tpu_torch.ops.lstm_train",
                    "stt_tpu_torch.config", "stt_tpu_torch.data.sources",
                    "stt_tpu_torch.data.feeding", "stt_tpu_torch.train.step",
                    "stt_tpu_torch.train.checkpoints", "stt_tpu_torch.train.trainer",
                    "stt_tpu_torch.train.__main__"}
        assert training <= set(names), training - set(names)
        opt_in = {"stt_tpu_torch.ops.quant", "stt_tpu_torch.ops.beam_kernel",
                  "stt_tpu_torch.decode.device"}
        assert opt_in <= set(names), opt_in - set(names)
        lm = {"stt_tpu_torch.decode.native", "stt_tpu_torch.decode.scorer_package",
              "stt_tpu_torch.decode.fst_dict", "stt_tpu_torch.decode.fst_writer",
              "stt_tpu_torch.decode.trie", "stt_tpu_torch.lm.kenlm", "stt_tpu_torch.lm.murmur",
              "stt_tpu_torch.lm.arpa", "stt_tpu_torch.lm.trie_writer",
              "stt_tpu_torch.tools.generate_scorer_package"}
        assert lm <= set(names), lm - set(names)
        m9 = {"stt_tpu_torch.evaluate", "stt_tpu_torch.evaluate_tools", "stt_tpu_torch.text",
              "stt_tpu_torch.evaluate_from_csv", "stt_tpu_torch.evaluate_export",
              "stt_tpu_torch.export", "stt_tpu_torch.transcribe", "stt_tpu_torch.data.vad"}
        assert m9 <= set(names), m9 - set(names)
        p6 = {"stt_tpu_torch.data." + m for m in (
            "audio", "helpers", "flac", "ogg", "vorbis", "sph", "opus", "mp3", "augmentations",
            "feature_cache", "stm", "auto_input")}
        assert p6 <= set(names), p6 - set(names)
        m12_m13 = {"stt_tpu_torch.serve.pool", "stt_tpu_torch.data.device_augment",
                   "stt_tpu_torch.parallel", "stt_tpu_torch.parallel.distributed",
                   "stt_tpu_torch.parallel.mesh"}
        assert m12_m13 <= set(names), m12_m13 - set(names)
        m13_m14 = {"stt_tpu_torch.parallel.tp", "stt_tpu_torch.lm_optimizer",
                   "stt_tpu_torch.training_graph_inference", "stt_tpu_torch.evaluate_flashlight",
                   "stt_tpu_torch.decode.flashlight", "stt_tpu_torch.evaluate_wav2vec2am"}
        assert m13_m14 <= set(names), m13_m14 - set(names)
        m15 = {"stt_tpu_torch." + m for m in (
            "compat", "compat.tflite", "compat.tf_checkpoint", "compat.tflite_export", "io",
            "native_build",
            "serve.cbridge", "serve.capi", "tools.downloader", "tools.generate_lm",
            "tools.enumerate_kenlm_vocabulary", "tools.trie_load", "tools.data_set_tool",
            "tools.check_characters", "tools.compare_samples", "tools.stats", "tools.play")}
        assert m15 <= set(names), m15 - set(names)
        scripts = {"stt_tpu_torch." + m for m in (
            "tools.benchmark", "tools.probe_stream_latency", "tools.reference_decoder_oracle",
            "bin", "bin.make_spliced_corpus", "ops.launch_log")}
        assert scripts <= set(names), scripts - set(names)
        assert "bench" not in sys.modules, "the repository's bench.py is imported"
        assert "tensorflow" not in sys.modules, "TensorFlow is imported by a call, not on import"
        print(len(names))
    """)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 100


def test_deepspeech_entry_points_load_nothing_of_wav2vec2_or_transformers():
    proc = run("""
        import sys
        import stt_tpu_torch.evaluate, stt_tpu_torch.models, stt_tpu_torch.serve
        loaded = [m for m in sys.modules if m.split(".")[0] == "transformers"
                  or m in ("stt_tpu_torch.models.wav2vec2", "stt_tpu_torch.evaluate_wav2vec2am")]
        assert not loaded, loaded
        assert "stt_tpu_torch.models.deepspeech" in sys.modules
    """)
    assert proc.returncode == 0, proc.stderr


def test_no_import_statement_names_jax_or_stt_tpu():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "stt_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "stt_tpu"), (path, mod)


def test_scripts_and_tools_name_nothing_of_stt_tpu_jax_or_bench():
    """The port's scripts (stt_tpu_torch/bin/*.sh, make_spliced_corpus.py)
    and its benchmark, probe and oracle tools name no stt_tpu module, no
    JAX and not the repository's bench.py; the shell scripts run only
    `python -m stt_tpu_torch.` modules, inline `python -` / `python -c`
    code, and files under stt_tpu_torch/."""
    import re

    bin_dir = os.path.join(ROOT, "stt_tpu_torch", "bin")
    scripts = sorted(n for n in os.listdir(bin_dir) if n.endswith(".sh"))
    assert len(scripts) == 7, scripts
    files = [os.path.join(bin_dir, n) for n in scripts + ["make_spliced_corpus.py"]] + [
        os.path.join(ROOT, "stt_tpu_torch", "tools", n) for n in (
            "benchmark.py", "probe_stream_latency.py", "reference_decoder_oracle.py",
            "oracle_main.cpp")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not re.search(r"\bstt_tpu\.\w", text.replace("stt_tpu_torch", "")), path
        assert not re.search(r"\bjax\b|JAX_PLATFORMS|XLA_FLAGS", text), path
        assert not re.search(r"import bench\b|from bench\b|benchmod|bench\.speechlike", text), path
        if path.endswith(".sh"):
            for call in re.findall(r"\bpython3?\b[^\n]*", text):
                assert re.match(r"python (-m stt_tpu_torch\.\w|-c |- |stt_tpu_torch/)", call), (
                    path, call)
            for call in re.findall(r"\bsh (\S+)", text):
                assert call.startswith("stt_tpu_torch/bin/"), (path, call)
            assert 'device="${device:-cuda}"' in text, path


def test_native_decoder_builds_under_build_native_and_loads_nothing_of_stt_tpu():
    """The C++ decoder is the port's own copy, built into build/native/ at
    the root of the checkout; nothing under stt_tpu/ is read or loaded."""
    proc = run("""
        import sys
        from pathlib import Path
        from stt_tpu_torch.decode import native
        root = Path.cwd().resolve()
        assert native.SOURCE == root / "stt_tpu_torch" / "native" / "ctc_decoder.cpp", native.SOURCE
        assert native.LIBRARY == root / "build" / "native" / "libstt_decoder.so", native.LIBRARY
        native.library()
        maps = Path("/proc/self/maps").read_text()
        assert str(native.LIBRARY) in maps
        assert str(root / "stt_tpu") + "/" not in maps, "a library under stt_tpu/ is loaded"
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "stt_tpu")]
    """)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(ROOT, "stt_tpu_torch", "decode", "native.py")) as f:
        assert "stt_tpu/native" not in f.read()


def test_decoder_harnesses_build_under_build_native_from_the_ports_sources():
    """decoder_smoke (ASan/UBSan) and prof_decoder are built from the port's
    own sources into build/native/ at the root of the checkout, and neither
    their build commands nor the libraries they link name stt_tpu/."""
    from pathlib import Path

    from stt_tpu_torch import native_build

    root = Path(ROOT).resolve()
    native = root / "stt_tpu_torch" / "native"
    for build, name, sources in (
            (native_build.build_decoder_smoke, "decoder_smoke_asan",
             ("ctc_decoder.cpp", "decoder_smoke.cc")),
            (native_build.build_prof_decoder, "prof_decoder", ("prof_decoder.cc",))):
        binary = build()
        assert binary == root / "build" / "native" / name, binary
        command = binary.with_name(name + ".cmd").read_text().split()
        assert [str(native / s) for s in sources] == [a for a in command if a.endswith(sources)]
        assert "stt_tpu/" not in " ".join(command).replace("stt_tpu_torch/", "")
        linked = subprocess.run(["ldd", str(binary)], capture_output=True, text=True, timeout=60)
        assert linked.returncode == 0 and str(root / "stt_tpu") + "/" not in linked.stdout
    with open(os.path.join(ROOT, "stt_tpu_torch", "native", "prof_decoder.cc")) as f:
        assert '#include "ctc_decoder.cpp"' in f.read()  # the port's copy, beside it


def test_c_api_builds_under_build_native_and_loads_nothing_of_stt_tpu():
    """libstt_tpu_torch.so is built from the port's own sources into
    build/native/ and, loaded, maps nothing under stt_tpu/; its bridge and
    its build module name neither stt_tpu's native directory nor its
    serving package."""
    proc = run("""
        import ctypes, sys
        from pathlib import Path
        from stt_tpu_torch.serve import capi
        root = Path.cwd().resolve()
        assert capi.SOURCE == root / "stt_tpu_torch" / "native" / "stt_c_api.cpp", capi.SOURCE
        assert capi.CLIENT_SOURCE == root / "stt_tpu_torch" / "native" / "stt_client.c"
        assert capi.LIBRARY == root / "build" / "native" / "libstt_tpu_torch.so", capi.LIBRARY
        lib = ctypes.CDLL(str(capi.library()))
        lib.STT_Version.restype = ctypes.c_char_p
        assert lib.STT_Version() == b"0.1.0"
        maps = Path("/proc/self/maps").read_text()
        assert str(capi.LIBRARY) in maps
        assert str(root / "stt_tpu") + "/" not in maps, "a library under stt_tpu/ is loaded"
        assert "stt_tpu_torch.serve.cbridge" in sys.modules
        assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "stt_tpu")]
    """)
    assert proc.returncode == 0, proc.stderr
    for name in ("serve/cbridge.py", "serve/capi.py", "native_build.py", "native/stt_c_api.cpp"):
        with open(os.path.join(ROOT, "stt_tpu_torch", name)) as f:
            text = f.read()
        assert "stt_tpu/native" not in text and "stt_tpu.serve" not in text, name


def test_cbridge_defaults_to_cuda_and_raises_without_it(tmp_path):
    proc = run(f"""
        import torch
        from stt_tpu_torch.alphabet import Alphabet
        from stt_tpu_torch.artifact import build_metadata, save_artifact
        from stt_tpu_torch.frontend import FeatureConfig
        from stt_tpu_torch.models import DeepSpeech, ModelConfig
        from stt_tpu_torch.serve import cbridge
        assert not torch.cuda.is_available()
        cfg = ModelConfig(n_hidden=8, n_cell_dim=8, n_out=4)
        alphabet = Alphabet().init_from_labels(["a", "b", " "])
        model = DeepSpeech(cfg, generator=torch.Generator().manual_seed(0))
        path = save_artifact({str(tmp_path / "m")!r}, model,
                             build_metadata(cfg, FeatureConfig(), alphabet), alphabet)
        try:
            cbridge.create_model(path)
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("cbridge.create_model ran without CUDA")
        assert not cbridge._MODELS
        cbridge.set_device("cpu")
        handle = cbridge.create_model(path)
        assert cbridge._MODELS[handle].device.type == "cpu"
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr


def test_model_defaults_to_cuda_and_raises_without_it(tmp_path):
    proc = run(f"""
        import torch
        from stt_tpu_torch.alphabet import Alphabet
        from stt_tpu_torch.artifact import build_metadata, save_artifact
        from stt_tpu_torch.frontend import FeatureConfig
        from stt_tpu_torch.models import DeepSpeech, ModelConfig
        from stt_tpu_torch.serve import Model
        assert not torch.cuda.is_available()
        cfg = ModelConfig(n_hidden=8, n_cell_dim=8, n_out=4)
        alphabet = Alphabet().init_from_labels(["a", "b", " "])
        model = DeepSpeech(cfg, generator=torch.Generator().manual_seed(0))
        path = save_artifact({str(tmp_path / "m")!r}, model,
                             build_metadata(cfg, FeatureConfig(), alphabet), alphabet)
        assert Model(path, device="cpu").device.type == "cpu"
        assert Model(path, quantized_inference=True, device="cpu")._qparams is not None
        assert Model(path, device="cpu").create_stream(device_decode=True)._state.device_decode
        for quantized in (False, True):
            try:
                Model(path, quantized_inference=quantized)
            except RuntimeError as e:
                assert "CUDA is not available" in str(e)
            else:
                raise AssertionError("Model(path) ran without CUDA")
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr


def test_train_defaults_to_cuda_and_raises_without_it(tmp_path):
    proc = run(f"""
        import torch
        from stt_tpu_torch.config import SttConfig
        from stt_tpu_torch.train.trainer import train
        assert not torch.cuda.is_available()
        alphabet = {str(tmp_path / "alphabet.txt")!r}
        open(alphabet, "w").write("a\\nb\\n")
        try:
            train(SttConfig(alphabet_config_path=alphabet, n_hidden=8, epochs=1))
        except RuntimeError as e:
            assert "CUDA is not available" in str(e)
        else:
            raise AssertionError("train(config) ran without CUDA")
        state = train(SttConfig(alphabet_config_path=alphabet, n_hidden=8, epochs=1), device="cpu")
        assert state.step == 0 and next(state.model.parameters()).device.type == "cpu"
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr


def test_evaluate_export_and_transcribe_default_to_cuda_and_raise_without_it(tmp_path):
    """The M9 entry points run on the card unless asked for the CPU."""
    proc = run(f"""
        import torch
        from stt_tpu_torch.alphabet import Alphabet
        from stt_tpu_torch.artifact import build_metadata, save_artifact
        from stt_tpu_torch.config import SttConfig
        from stt_tpu_torch.evaluate import evaluate
        from stt_tpu_torch.evaluate_export import evaluate_export
        from stt_tpu_torch.export import export
        from stt_tpu_torch.frontend import FeatureConfig
        from stt_tpu_torch.models import DeepSpeech, ModelConfig
        from stt_tpu_torch.transcribe import main as transcribe
        assert not torch.cuda.is_available()
        alphabet = {str(tmp_path / "alphabet.txt")!r}
        open(alphabet, "w").write("a\\nb\\n")
        cfg = ModelConfig(n_hidden=8, n_cell_dim=8, n_out=3)
        labels = Alphabet(alphabet)
        model = DeepSpeech(cfg, generator=torch.Generator().manual_seed(0))
        path = save_artifact({str(tmp_path / "m")!r}, model,
                             build_metadata(cfg, FeatureConfig(), labels), labels)
        config = SttConfig(alphabet_config_path=alphabet, n_hidden=8, test_files=["x.csv"],
                           checkpoint_dir={str(tmp_path / "ckpt")!r},
                           export_dir={str(tmp_path / "e")!r})
        calls = [lambda: evaluate(config, model=model), lambda: export(config),
                 lambda: evaluate_export(path, "x.csv"),
                 lambda: transcribe(["--src", "x.wav", "--model_dir", path])]
        for call in calls:
            try:
                call()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e), e
            else:
                raise AssertionError("an entry point ran without CUDA")
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr


def test_m14_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """The one-shot inference, the LM optimizer, the flashlight evaluation
    and the wav2vec2 evaluation's batch decode run on the card unless asked
    for the CPU."""
    proc = run(f"""
        import json, os
        import numpy as np
        import torch
        from stt_tpu_torch.config import SttConfig
        from stt_tpu_torch.data.sources import CSVWriter, Sample
        from stt_tpu_torch.evaluate_flashlight import evaluate_flashlight, one_shot_infer
        from stt_tpu_torch.evaluate_wav2vec2am import evaluate_wav2vec2am
        from stt_tpu_torch.lm_optimizer import compute_lm_optimization
        from stt_tpu_torch.training_graph_inference import do_single_file_inference
        assert not torch.cuda.is_available()
        root = {str(tmp_path)!r}
        alphabet = os.path.join(root, "alphabet.txt")
        open(alphabet, "w").write("a\\nb\\n")
        csv = os.path.join(root, "t.csv")
        with CSVWriter(csv) as w:
            w.add(Sample("t0", "ab", _audio=np.zeros(8000, np.float32), _rate=16000))
        os.makedirs(os.path.join(root, "am", "em"))
        json.dump({{"alphabet_labels": ["<pad>", "a", "b"], "blank_id": 0}},
                  open(os.path.join(root, "am", "config.json"), "w"))
        from stt_tpu_torch.evaluate_wav2vec2am import read_csv_entries
        stem = os.path.splitext(os.path.basename(read_csv_entries([csv])[0][0]))[0]
        np.save(os.path.join(root, "am", "em", stem + ".npy"), np.full((5, 3), 1 / 3, np.float32))
        config = SttConfig(alphabet_config_path=alphabet, n_hidden=8, test_files=[csv],
                           checkpoint_dir=os.path.join(root, "ckpt"), scorer_path="x.scorer")
        calls = [lambda: do_single_file_inference(config, "x.wav"),
                 lambda: compute_lm_optimization(config, n_trials=1),
                 lambda: evaluate_flashlight(config), lambda: one_shot_infer(config, "x.wav"),
                 lambda: evaluate_wav2vec2am([csv], os.path.join(root, "am"),
                                             emissions_dir=os.path.join(root, "am", "em"))]
        for call in calls:
            try:
                call()
            except RuntimeError as e:
                assert "CUDA is not available" in str(e), e
            else:
                raise AssertionError("an entry point ran without CUDA")
        [r] = evaluate_wav2vec2am([csv], os.path.join(root, "am"),
                                  emissions_dir=os.path.join(root, "am", "em"), device="cpu")
        assert r.src == "ab"
    """, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

"""``VoiceFemininityScoring`` of the port: VAD, VBx features, ResNet
x-vectors and the femininity MLP.

Built through the public constructor with the benchmark's weights (the
Keras models in a model directory, the ResNet as ``xvector_params=`` on
the configuration's ``xvector_net=``),
``ffmpeg=None`` and no download.  A forward hook on the port's MLP keeps,
for every file the timed calls score on the calling thread, the x-vectors
it was given and the probabilities it returned.  Nothing the hook sees is
counted: the FLOPs of the per-layer metrics come from the answers
(``counts.vfs_flops``).
"""

from __future__ import annotations

import threading

import numpy as np


class System:
    # the numbers a run compares (and those it only prints), at their start
    NUMBERS = {"xvector_gap": 0.0, "probability_gap": 0.0,
               "answers_differ": 0, "scores_inconsistent": 0,
               "unaligned_files": 0, "files_compared": 0}

    def __init__(self, config, weights, model_dir, device):
        from inaspeechsegmenter_tpu_torch import VoiceFemininityScoring
        from inaspeechsegmenter_tpu_torch.models.resnet import ResNetXVector

        c, r = config["constructor"], config["models"]["resnet"]
        self.config = config
        net = ResNetXVector(r["block"], tuple(r["num_blocks"]),
                            r["m_channels"], r["feat_dim"], r["embed_dim"])
        self.obj = VoiceFemininityScoring(
            c["gd_model_criteria"], "pytorch", False,
            weights["resnet"]["numpy"], net, None, device=device,
            model_dir=model_dir)
        self.capture_thread = None
        self.captured = []
        self._hook = self.obj.gender_detection_mlp_model \
            .register_forward_hook(self._mlp_hook)

    def _mlp_hook(self, module, args, out):
        if threading.get_ident() == self.capture_thread:
            self.captured.append((args[0].detach(), out.detach()))

    # -- driving ------------------------------------------------------------
    def batch(self, wavs, outs):
        return [m[1] for m in self.obj.batch_score(wavs, outs)[3]]

    def decode_seconds(self):
        return None

    def describe(self):
        from inaspeechsegmenter_tpu_torch import segmenter

        return {"frontend": type(self.obj.vad.frontend).__name__,
                "link_mbps": {k: v[0] for k, v in
                              segmenter._LINK_MBPS.items()}}

    def start_capture(self):
        self.capture_thread = threading.get_ident()

    def stop_capture(self):
        self.capture_thread = None
        self.captured = [(x.float().cpu().numpy(), p.float().cpu().numpy())
                         for x, p in self.captured]

    def close(self):
        self._hook.remove()
        self.obj = None

    # -- answers ------------------------------------------------------------
    def answer(self, out):
        """(score | None, speech_duration, nb_vectors) of an answer's csv."""
        with open(out) as fh:
            row = fh.read().splitlines()[1].split("\t")
        return (float(row[0]) if row[0] else None, float(row[1]),
                int(row[2]))

    def work(self, answers):
        """What the answers hold, for the run's information lines."""
        return {"speech_s": float(sum(a[1] for a in answers)),
                "xvectors": int(sum(a[2] for a in answers))}

    def align(self, answers):
        """One MLP call a file with retained x-vectors, in order ->
        [(xvectors, probs) | () | None]: () for a file with none, None
        where the rows do not match the answer's count."""
        out, pos = [], 0
        for score, sd, nb in answers:
            if nb == 0:
                out.append(())
                continue
            if pos >= len(self.captured) or len(self.captured[pos][0]) != nb:
                break
            out.append(self.captured[pos])
            pos += 1
        return out + [None] * (len(answers) - len(out))

    def compare(self, answer, aligned, ref, numbers):
        score, sd, nb = answer
        numbers["files_compared"] += 1
        differ = (nb != len(ref["probs"])
                  or abs(sd - ref["speech_duration"]) > 1e-6)
        numbers["answers_differ"] += int(differ)
        numbers["unaligned_files"] += aligned is None
        if aligned is None or differ or nb == 0:
            if aligned == () and score is not None:
                numbers["scores_inconsistent"] += 1
            return
        x, p = aligned
        p = p.reshape(-1)
        if score is None or float(np.mean(p >= 0.5)) != score:
            numbers["scores_inconsistent"] += 1
        from perfbench.reference.plain import relative_gap

        numbers["xvector_gap"] = max(numbers["xvector_gap"],
                                     relative_gap(x, ref["xvectors"]))
        numbers["probability_gap"] = max(
            numbers["probability_gap"],
            float(np.max(np.abs(p - ref["probs"]))))


"""``Segmenter`` of the port: speech / music / noise (and gender)
segmentation.

Built through the public constructor, with the benchmark's weights in a
model directory, ``ffmpeg=None`` and no download.  Forward hooks on the
port's CNN modules keep every output the timed calls compute on the
calling thread (the patches of the energy-active frames through the VAD
CNN, of the speech frames through the gender CNN, in frame order, file
after file), so that the posteriors the window produced are the ones
compared.  Nothing the hooks see is counted: the FLOPs of the per-layer
metrics come from the answers (``counts.cnn_flops``).
"""

from __future__ import annotations

import csv
import threading

import numpy as np


class System:
    # the numbers a run compares (and those it only prints), at their start
    NUMBERS = {"log_posterior_gap": 0.0, "label_frames_differ": 0,
               "unaligned_files": 0, "frames_compared": 0,
               "ref_active_frames": 0, "ref_speech_frames": 0}

    def __init__(self, config, weights, model_dir, device):
        from inaspeechsegmenter_tpu_torch import Segmenter

        c = config["constructor"]
        self.config = config
        self.obj = Segmenter(c["vad_engine"], c["detect_gender"], None,
                             c["batch_size"], c["energy_ratio"], False,
                             device=device, model_dir=model_dir)
        self.labels = list(self.obj.labels)
        self.stages = {"vad": self.obj.vad.model}
        if c["detect_gender"]:
            self.stages["gender"] = self.obj.gender.model
        self.capture_thread = None
        self.captured = {k: [] for k in self.stages}
        self._hooks = [m.register_forward_hook(self._hook(k))
                       for k, m in self.stages.items()]

    def _hook(self, stage):
        def hook(module, args, out):
            if threading.get_ident() == self.capture_thread:
                self.captured[stage].append(out.detach())
        return hook

    # -- driving ------------------------------------------------------------
    def batch(self, wavs, outs):
        """One ``batch_process`` call -> a status a file (0 ok)."""
        return [m[1] for m in self.obj.batch_process(wavs, outs)[3]]

    def call(self, wav):
        return self.obj(wav)

    def decode_seconds(self):
        return self.obj.timers.totals["decode"]

    def describe(self):
        from inaspeechsegmenter_tpu_torch import segmenter

        return {"frontend": type(self.obj.frontend).__name__,
                "link_mbps": {k: v[0] for k, v in
                              segmenter._LINK_MBPS.items()}}

    def start_capture(self):
        self.capture_thread = threading.get_ident()

    def stop_capture(self):
        """Stop keeping outputs and take them to the host."""
        self.capture_thread = None
        self.captured = {k: [t.float().cpu().numpy() for t in v]
                         for k, v in self.captured.items()}

    def close(self):
        for h in self._hooks:
            h.remove()
        self.obj = self.stages = None

    # -- answers ------------------------------------------------------------
    def answer(self, out):
        """(n20,) label ids of an answer: a csv path or the call's list of
        (label, start_s, stop_s)."""
        if isinstance(out, str):
            with open(out) as fh:
                rows = list(csv.reader(fh, delimiter="\t"))[1:]
            out = [(r[0], float(r[1]), float(r[2])) for r in rows]
        ids = []
        for lab, a, b in out:
            ids += [self.labels.index(lab)] * (int(round(b / .02))
                                               - int(round(a / .02)))
        return np.asarray(ids, np.int64)

    def work(self, answers):
        """What the answers hold, for the run's information lines."""
        return {"frames": int(sum(len(a) for a in answers)),
                "energy_active": int(sum(int(np.sum(a != 0))
                                         for a in answers)),
                "speech": int(sum(int(np.sum(self.stage_masks(a).get(
                    "gender", a == 1))) for a in answers))}

    def stage_masks(self, labels):
        """The frames each CNN reads, by the answer's own labels: the VAD
        the energy-active ones, the gender CNN the speech ones."""
        masks = {"vad": labels != 0}
        if "gender" in self.stages:
            masks["gender"] = labels >= 4
        return masks

    def align(self, answers):
        """Split the captured outputs into the answers' files, in the order
        they were produced -> [{stage: (frames, probs)} | None]: None where
        the rows do not add up to the frames the labels say were read."""
        pos = {k: 0 for k in self.captured}
        out = []
        for labels in answers:
            item = {}
            for stage, mask in self.stage_masks(labels).items():
                need = int(mask.sum())
                got, rows = 0, []
                while got < need and pos[stage] < len(self.captured[stage]):
                    rows.append(self.captured[stage][pos[stage]])
                    got += len(rows[-1])
                    pos[stage] += 1
                if got != need:
                    item = None
                    break
                p = (np.concatenate(rows) if rows
                     else np.zeros((0, 1), np.float32))
                item[stage] = (np.flatnonzero(mask), p)
            out.append(item)
            if item is None:
                break
        return out + [None] * (len(answers) - len(out))

    def compare(self, answer, aligned, ref, numbers):
        """Hold one answer against the reference: label frames that
        differ, and the largest gap of the log-posteriors (what the decodes
        read) on the frames both read."""
        labels = answer
        n = min(len(labels), len(ref["labels"]))
        diff = int(np.sum(labels[:n] != ref["labels"][:n])
                   + abs(len(labels) - len(ref["labels"])))
        numbers["label_frames_differ"] += diff
        numbers["frames_compared"] += len(ref["labels"])
        numbers["ref_active_frames"] += int(ref["active"].sum())
        numbers["ref_speech_frames"] += int(ref["speech"].sum())
        numbers["unaligned_files"] += aligned is None
        if aligned is None:
            return
        for stage, (frames, p) in aligned.items():
            post = ref["post_" + stage]
            mask = ref["active"] if stage == "vad" else ref["speech"]
            keep = frames < len(post)
            frames, p = frames[keep], np.nan_to_num(p[keep], nan=0.5)
            both = mask[frames]
            if both.any():
                gap = float(np.max(np.abs(_log(p[both])
                                          - _log(post[frames[both]]))))
                numbers["log_posterior_gap"] = max(
                    numbers["log_posterior_gap"], gap)


def _log(p):
    return np.log(np.maximum(np.asarray(p, np.float64), 1e-30))


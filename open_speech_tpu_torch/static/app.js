/* Open Speech TPU web UI.
 *
 * Functional equivalent of the reference UI (src/static/app.js): tabs for
 * file + live-mic transcription (streaming WS with VAD indicator), TTS with
 * voices/blending/capability gating, model browser with download/load
 * progress polling, history, and studio (profiles + conversations).
 */
"use strict";

const $ = (sel) => document.querySelector(sel);
const api = (path, opts) => fetch(path, opts).then(async (r) => {
  if (!r.ok) {
    let msg = r.statusText;
    try { msg = (await r.json()).error.message; } catch (_e) {}
    throw new Error(msg);
  }
  return r;
});

/* ── tabs ─────────────────────────────────────────────────────────── */

document.querySelectorAll("#tabs button").forEach((btn) => {
  btn.addEventListener("click", () => {
    document.querySelectorAll("#tabs button").forEach((b) => b.classList.remove("active"));
    document.querySelectorAll(".tab").forEach((t) => t.classList.remove("active"));
    btn.classList.add("active");
    $(`#tab-${btn.dataset.tab}`).classList.add("active");
    if (btn.dataset.tab === "models") loadModels();
    if (btn.dataset.tab === "history") loadHistory();
    if (btn.dataset.tab === "studio") {
      loadProfiles(); loadConversations();
      loadComposerRenders(); loadComposerSources();
    }
  });
});

/* ── health ───────────────────────────────────────────────────────── */

async function checkHealth() {
  try {
    const h = await (await api("/health")).json();
    $("#health").textContent = `● v${h.version} · ${h.models_loaded} loaded`;
    $("#health").className = "health ok";
  } catch (_e) {
    $("#health").className = "health err";
  }
}
checkHealth();
setInterval(checkHealth, 15000);

/* ── transcribe: file ─────────────────────────────────────────────── */

async function loadSttModels() {
  const data = await (await api("/api/models")).json();
  const sel = $("#stt-model");
  sel.innerHTML = "";
  data.models.filter((m) => m.type === "stt").forEach((m) => {
    const opt = document.createElement("option");
    opt.value = m.id;
    opt.textContent = m.id + (m.is_default ? " (default)" : "");
    if (m.is_default) opt.selected = true;
    sel.appendChild(opt);
  });
}

$("#stt-go").addEventListener("click", async () => {
  const file = $("#stt-file").files[0];
  if (!file) { $("#stt-result").textContent = "Pick a file first."; return; }
  const fd = new FormData();
  fd.append("file", file);
  fd.append("model", $("#stt-model").value);
  fd.append("response_format", $("#stt-format").value);
  $("#stt-result").textContent = "Transcribing…";
  try {
    const r = await api("/v1/audio/transcriptions", { method: "POST", body: fd });
    const text = await r.text();
    try { $("#stt-result").textContent = JSON.stringify(JSON.parse(text), null, 2); }
    catch (_e) { $("#stt-result").textContent = text; }
  } catch (e) {
    $("#stt-result").textContent = `Error: ${e.message}`;
  }
});

/* ── transcribe: live mic over WS ─────────────────────────────────── */

let micCtx = null, micWs = null, micStream = null, micNode = null;

function f32ToPcm16(f32) {
  const out = new Int16Array(f32.length);
  for (let i = 0; i < f32.length; i++) {
    const v = Math.max(-1, Math.min(1, f32[i]));
    out[i] = v * 32767;
  }
  return out.buffer;
}

async function startMic() {
  micStream = await navigator.mediaDevices.getUserMedia({ audio: true });
  micCtx = new AudioContext();
  const rate = micCtx.sampleRate;
  const scheme = location.protocol === "https:" ? "wss" : "ws";
  const model = $("#stt-model").value;
  micWs = new WebSocket(
    `${scheme}://${location.host}/v1/audio/stream?sample_rate=${rate}` +
    (model ? `&model=${encodeURIComponent(model)}` : "")
  );
  micWs.onmessage = (evt) => {
    const e = JSON.parse(evt.data);
    if (e.type === "vad") {
      const el = $("#vad-indicator");
      el.textContent = e.state === "speech_start" ? "speech" : "silence";
      el.className = e.state === "speech_start" ? "vad speech" : "vad";
    } else if (e.type === "transcript") {
      if (e.is_final) {
        $("#live-final").textContent += (e.speech_final ? e.text + " " : "");
        if (!e.speech_final) $("#live-interim").textContent = e.text;
      } else {
        $("#live-interim").textContent = e.text;
      }
      if (e.speech_final) $("#live-interim").textContent = "";
    }
  };
  const src = micCtx.createMediaStreamSource(micStream);
  micNode = micCtx.createScriptProcessor(4096, 1, 1);
  micNode.onaudioprocess = (e) => {
    if (micWs && micWs.readyState === WebSocket.OPEN) {
      micWs.send(f32ToPcm16(e.inputBuffer.getChannelData(0)));
    }
  };
  src.connect(micNode);
  micNode.connect(micCtx.destination);
  $("#mic-toggle").textContent = "Stop mic";
}

function stopMic() {
  if (micWs && micWs.readyState === WebSocket.OPEN) {
    micWs.send(JSON.stringify({ type: "stop" }));
    micWs.close();
  }
  if (micNode) micNode.disconnect();
  if (micStream) micStream.getTracks().forEach((t) => t.stop());
  if (micCtx) micCtx.close();
  micCtx = micWs = micStream = micNode = null;
  $("#mic-toggle").textContent = "Start mic";
  $("#vad-indicator").textContent = "silence";
  $("#vad-indicator").className = "vad";
}

$("#mic-toggle").addEventListener("click", () => (micCtx ? stopMic() : startMic()));

/* ── speak ────────────────────────────────────────────────────────── */

async function loadVoices() {
  const modelSel = $("#tts-model");
  const data = await (await api("/api/models")).json();
  modelSel.innerHTML = "";
  data.models.filter((m) => m.type === "tts").forEach((m) => {
    const opt = document.createElement("option");
    opt.value = m.id;
    opt.textContent = m.id;
    if (m.is_default) opt.selected = true;
    modelSel.appendChild(opt);
  });
  await refreshVoiceList();
}

/* voice blend builder: chips of (voice, weight) composing the spec string */
let blendParts = [];

function blendSpec() {
  return blendParts.map((b) => `${b.voice}(${b.weight})`).join("+");
}

function renderBlendChips() {
  const holder = $("#blend-chips");
  holder.innerHTML = "";
  blendParts.forEach((b, i) => {
    const chip = document.createElement("span");
    chip.className = "chip";
    chip.textContent = `${b.voice} ×${b.weight} `;
    const x = document.createElement("button");
    x.textContent = "✕";
    x.className = "small";
    x.addEventListener("click", () => {
      blendParts.splice(i, 1);
      renderBlendChips();
    });
    chip.appendChild(x);
    holder.appendChild(chip);
  });
}

$("#blend-add").addEventListener("click", () => {
  const voice = $("#blend-picker").value;
  const weight = Number($("#blend-weight").value) || 1.0;
  if (voice && !blendParts.find((b) => b.voice === voice)) {
    blendParts.push({ voice, weight });
    renderBlendChips();
  }
});

async function refreshVoiceList() {
  const model = $("#tts-model").value;
  const data = await (
    await api(`/v1/audio/voices${model ? `?model=${encodeURIComponent(model)}` : ""}`)
  ).json();
  for (const sel of [$("#tts-voice"), $("#blend-picker")]) {
    sel.innerHTML = "";
    data.voices.forEach((v) => {
      const opt = document.createElement("option");
      opt.value = v.id;
      opt.textContent = sel.id === "tts-voice" ? `${v.id} (${v.language})` : v.id;
      sel.appendChild(opt);
    });
  }
  // capability-gated controls (voice_blend / voice_design / voice_clone /
  // streaming) — reference gates the same way (src/static/app.js:255-290)
  let caps = {};
  try {
    caps = (await (
      await api(`/api/tts/capabilities?model=${encodeURIComponent(model)}`)
    ).json()).capabilities || {};
  } catch (_e) { /* default: everything hidden */ }
  $("#tts-blend-row").style.display = caps.voice_blend ? "flex" : "none";
  if (!caps.voice_blend) { blendParts = []; renderBlendChips(); }
  $("#tts-advanced").style.display = caps.voice_design ? "flex" : "none";
  $("#tts-clone").style.display = caps.voice_clone ? "flex" : "none";
  $("#tts-stream-label").style.display = caps.streaming !== false ? "inline-flex" : "none";
}

$("#tts-model").addEventListener("change", refreshVoiceList);
$("#tts-speed").addEventListener("input", () => {
  $("#tts-speed-val").textContent = Number($("#tts-speed").value).toFixed(1);
});

/* progressive playback of a streaming mp3 response via MediaSource
 * (reference: src/static/app.js doSpeak :384-460) */
async function playMediaSource(res, audioEl) {
  const ms = new MediaSource();
  audioEl.src = URL.createObjectURL(ms);
  await new Promise((resolve, reject) => {
    ms.addEventListener("sourceopen", () => {
      let sb;
      try { sb = ms.addSourceBuffer("audio/mpeg"); } catch (e) { reject(e); return; }
      const reader = res.body.getReader();
      const pump = async () => {
        try {
          const { done, value } = await reader.read();
          if (done) {
            if (ms.readyState === "open") ms.endOfStream();
            resolve();
            return;
          }
          if (sb.updating) {
            await new Promise((r) => sb.addEventListener("updateend", r, { once: true }));
          }
          sb.appendBuffer(value);
          sb.addEventListener("updateend", pump, { once: true });
        } catch (err) { reject(err); }
      };
      audioEl.addEventListener("canplay", () => audioEl.play().catch(() => {}), { once: true });
      pump();
    }, { once: true });
    ms.addEventListener("error", reject, { once: true });
  });
}

async function speakClone(t0) {
  const fd = new FormData();
  fd.append("input", $("#tts-text").value);
  fd.append("model", $("#tts-model").value);
  fd.append("reference_audio", $("#tts-clone-file").files[0]);
  const transcript = $("#tts-clone-transcript").value.trim();
  if (transcript) fd.append("transcript", transcript);
  fd.append("response_format", $("#tts-format").value);
  const r = await api("/v1/audio/speech/clone", { method: "POST", body: fd });
  const blob = await r.blob();
  $("#tts-audio").src = URL.createObjectURL(blob);
  $("#tts-audio").play().catch(() => {});
  $("#tts-status").textContent =
    `cloned · ${(blob.size / 1024).toFixed(0)} KB in ${((performance.now() - t0) / 1000).toFixed(1)}s`;
}

$("#tts-go").addEventListener("click", async () => {
  const t0 = performance.now();
  $("#tts-status").textContent = "Synthesizing…";
  try {
    if ($("#tts-clone").style.display !== "none" && $("#tts-clone-file").files[0]) {
      await speakClone(t0);
      return;
    }
    const fmt = $("#tts-format").value;
    const body = {
      input: $("#tts-text").value,
      model: $("#tts-model").value,
      voice: blendParts.length ? blendSpec() : $("#tts-voice").value,
      speed: Number($("#tts-speed").value),
      response_format: fmt,
    };
    const design = $("#tts-design").value.trim();
    if (design) body.voice_design = design;
    const wantStream = $("#tts-stream").checked && fmt === "mp3" &&
      window.MediaSource && MediaSource.isTypeSupported("audio/mpeg");
    const r = await api(`/v1/audio/speech${wantStream ? "?stream=true" : ""}`, {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify(body),
    });
    if (wantStream && r.body) {
      await playMediaSource(r, $("#tts-audio"));
      $("#tts-status").textContent =
        `streamed in ${((performance.now() - t0) / 1000).toFixed(1)}s`;
      return;
    }
    const blob = await r.blob();
    $("#tts-audio").src = URL.createObjectURL(blob);
    $("#tts-audio").play().catch(() => {});
    const cache = r.headers.get("X-Cache") === "HIT" ? " (cache hit)" : "";
    $("#tts-status").textContent =
      `${(blob.size / 1024).toFixed(0)} KB in ${((performance.now() - t0) / 1000).toFixed(1)}s${cache}`;
  } catch (e) {
    $("#tts-status").textContent = `Error: ${e.message}`;
  }
});

/* ── models ───────────────────────────────────────────────────────── */

async function loadModels() {
  const data = await (await api("/api/models")).json();
  const tbody = $("#models-table tbody");
  tbody.innerHTML = "";
  data.models
    .sort((a, b) => a.id.localeCompare(b.id))
    .forEach((m) => {
      const tr = document.createElement("tr");
      tr.innerHTML = `
        <td>${m.id}${m.is_default ? " ★" : ""}</td>
        <td>${m.type}</td>
        <td>${m.provider}</td>
        <td>${m.size_mb ? m.size_mb + " MB" : "—"}</td>
        <td><span class="state ${m.state}">${m.state}</span></td>
        <td></td>`;
      const actions = tr.lastElementChild;
      if (m.state === "loaded") {
        actions.appendChild(btn("Unload", "danger", () => modelOp(m.id, "DELETE", `/api/models/${m.id}`)));
      } else {
        actions.appendChild(btn("Load", "primary", () => modelOp(m.id, "POST", `/api/models/${m.id}/load`, tr)));
      }
      tbody.appendChild(tr);
    });
}

function btn(label, cls, onclick) {
  const b = document.createElement("button");
  b.textContent = label;
  b.className = `${cls} small`;
  b.addEventListener("click", onclick);
  return b;
}

async function modelOp(id, method, path, row) {
  try {
    const pending = api(path, { method });
    if (row) pollProgress(id, row);
    await pending;
  } catch (e) { alert(e.message); }
  loadModels();
}

async function pollProgress(id, row) {
  for (let i = 0; i < 600; i++) {
    try {
      const p = await (await api(`/api/models/${id}/progress`)).json();
      const cell = row.querySelector(".state");
      if (cell) cell.textContent = `${p.status} ${(p.progress * 100) | 0}%`;
      if (p.status === "ready" || p.status === "idle" || p.status === "downloaded") break;
    } catch (_e) { break; }
    await new Promise((res) => setTimeout(res, 1000));
  }
}

/* ── history ──────────────────────────────────────────────────────── */

async function loadHistory() {
  const data = await (await api("/api/history?limit=100")).json();
  const tbody = $("#history-table tbody");
  tbody.innerHTML = "";
  data.items.forEach((it) => {
    const tr = document.createElement("tr");
    tr.innerHTML = `
      <td>${new Date(it.created_at).toLocaleString()}</td>
      <td>${it.type}</td>
      <td>${it.model || ""}</td>
      <td>${it.text_preview || ""}</td>
      <td></td>`;
    tr.lastElementChild.appendChild(
      btn("Delete", "danger", async () => {
        await api(`/api/history/${it.id}`, { method: "DELETE" });
        loadHistory();
      })
    );
    tbody.appendChild(tr);
  });
}

$("#history-clear").addEventListener("click", async () => {
  await api("/api/history", { method: "DELETE" });
  loadHistory();
});

/* ── studio: profiles ─────────────────────────────────────────────── */

async function loadProfiles() {
  const data = await (await api("/api/profiles")).json();
  const tbody = $("#profiles-table tbody");
  tbody.innerHTML = "";
  data.profiles.forEach((p) => {
    const tr = document.createElement("tr");
    tr.innerHTML = `
      <td>${p.name}</td><td>${p.voice}</td><td>${p.speed}</td>
      <td>${p.id === data.default_profile_id ? "★" : ""}</td><td></td>`;
    const cell = tr.lastElementChild;
    cell.appendChild(btn("Default", "primary", async () => {
      await api(`/api/profiles/${p.id}/default`, { method: "POST" });
      loadProfiles();
    }));
    cell.appendChild(btn("Delete", "danger", async () => {
      await api(`/api/profiles/${p.id}`, { method: "DELETE" });
      loadProfiles();
    }));
    tbody.appendChild(tr);
  });
}

$("#profile-create").addEventListener("click", async () => {
  try {
    await api("/api/profiles", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({
        name: $("#profile-name").value,
        backend: "kokoro",
        voice: $("#profile-voice").value || "af_heart",
        speed: Number($("#profile-speed").value) || 1.0,
      }),
    });
    $("#profile-name").value = "";
    loadProfiles();
  } catch (e) { alert(e.message); }
});

/* ── studio: conversations ────────────────────────────────────────── */

async function loadConversations() {
  const data = await (await api("/api/conversations")).json();
  const list = $("#conv-list");
  list.innerHTML = "";
  data.items.forEach((c) => {
    const div = document.createElement("div");
    div.className = "conv";
    div.innerHTML = `<strong>${c.name || c.id}</strong> `;
    const addRow = document.createElement("div");
    addRow.className = "row";
    const speaker = document.createElement("input");
    speaker.placeholder = "speaker";
    const text = document.createElement("input");
    text.placeholder = "line of dialogue";
    addRow.append(speaker, text,
      btn("Add turn", "primary", async () => {
        await api(`/api/conversations/${c.id}/turns`, {
          method: "POST",
          headers: { "Content-Type": "application/json" },
          body: JSON.stringify({ speaker: speaker.value || "Speaker", text: text.value }),
        });
        text.value = "";
      }),
      btn("Render", "primary", async () => {
        const r = await (await api(`/api/conversations/${c.id}/render`, {
          method: "POST",
          headers: { "Content-Type": "application/json" },
          body: JSON.stringify({ format: "wav" }),
        })).json();
        const audio = document.createElement("audio");
        audio.controls = true;
        audio.src = r.download_url;
        div.appendChild(audio);
      }),
      btn("Delete", "danger", async () => {
        await api(`/api/conversations/${c.id}`, { method: "DELETE" });
        loadConversations();
      }));
    div.appendChild(addRow);
    list.appendChild(div);
  });
}

$("#conv-create").addEventListener("click", async () => {
  await api("/api/conversations", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ name: $("#conv-name").value || "Untitled", turns: [] }),
  });
  $("#conv-name").value = "";
  loadConversations();
});

/* ── studio: composer ─────────────────────────────────────────────── */

const composerTracks = [];

function renderComposerTracks() {
  const tbody = $("#composer-tracks tbody");
  tbody.innerHTML = "";
  composerTracks.forEach((t, i) => {
    const tr = document.createElement("tr");
    const mk = (tag, attrs) => {
      const el = document.createElement(tag);
      Object.assign(el, attrs);
      return el;
    };
    const src = mk("input", { value: t.source_path, placeholder: "data/…/render.wav" });
    src.setAttribute("list", "composer-sources");
    src.addEventListener("change", () => { t.source_path = src.value; });
    const vol = mk("input", { type: "number", value: t.volume, step: 0.1, min: 0, max: 4 });
    vol.addEventListener("change", () => { t.volume = Number(vol.value) || 1.0; });
    const off = mk("input", { type: "number", value: t.offset_s, step: 0.1, min: 0 });
    off.addEventListener("change", () => { t.offset_s = Number(off.value) || 0; });
    const mute = mk("input", { type: "checkbox", checked: t.muted });
    mute.addEventListener("change", () => { t.muted = mute.checked; });
    const solo = mk("input", { type: "checkbox", checked: t.solo });
    solo.addEventListener("change", () => { t.solo = solo.checked; });
    const fx = mk("input", { value: t.effects, placeholder: "normalize,reverb" });
    fx.addEventListener("change", () => { t.effects = fx.value; });
    [src, vol, off, mute, solo, fx].forEach((el) => {
      const td = document.createElement("td");
      td.appendChild(el);
      tr.appendChild(td);
    });
    const actions = document.createElement("td");
    actions.appendChild(btn("Remove", "danger", () => {
      composerTracks.splice(i, 1);
      renderComposerTracks();
    }));
    tr.appendChild(actions);
    tbody.appendChild(tr);
  });
}

async function loadComposerSources() {
  // suggest previous mixes as track sources (conversation renders and
  // voice-library WAVs can be typed/pasted — their paths are shown in
  // their own panels)
  try {
    const data = await (await api("/api/composer/renders")).json();
    const dl = $("#composer-sources");
    dl.innerHTML = "";
    (data.items || []).forEach((r) => {
      const p = r.render_output_path;
      if (p && p.endsWith(".wav")) {
        const opt = document.createElement("option");
        opt.value = p;
        dl.appendChild(opt);
      }
    });
  } catch (_e) { /* panel stays usable without suggestions */ }
}

async function loadComposerRenders() {
  const data = await (await api("/api/composer/renders")).json();
  const list = $("#composer-renders");
  list.innerHTML = "";
  (data.items || []).forEach((r) => {
    const div = document.createElement("div");
    div.className = "conv";
    const when = (r.created_at || "").replace("T", " ").slice(0, 19);
    div.innerHTML = `<strong>${r.name || r.id}</strong> ` +
      `<span class="hint">${when} · ${r.meta && r.meta.duration_ms ? (r.meta.duration_ms / 1000).toFixed(1) + "s" : ""}</span> `;
    const audio = document.createElement("audio");
    audio.controls = true;
    audio.src = `/api/composer/render/${r.id}/audio`;
    div.appendChild(audio);
    div.appendChild(btn("Delete", "danger", async () => {
      await api(`/api/composer/render/${r.id}`, { method: "DELETE" });
      loadComposerRenders();
      loadComposerSources();
    }));
    list.appendChild(div);
  });
}

$("#composer-add").addEventListener("click", () => {
  composerTracks.push({
    source_path: "", volume: 1.0, offset_s: 0, muted: false, solo: false,
    effects: "",
  });
  renderComposerTracks();
});

$("#composer-render").addEventListener("click", async () => {
  const tracks = composerTracks
    .filter((t) => t.source_path)
    .map((t) => ({
      source_path: t.source_path,
      volume: t.volume,
      offset_s: t.offset_s,
      muted: t.muted,
      solo: t.solo,
      effects: String(t.effects || "").split(",").map((s) => s.trim())
        .filter(Boolean).map((type) => ({ type })),
    }));
  if (!tracks.length) { alert("Add at least one track with a source path"); return; }
  try {
    await api("/api/composer/render", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({
        tracks,
        format: $("#composer-format").value,
        name: $("#composer-name").value || undefined,
      }),
    });
    loadComposerRenders();
    loadComposerSources();
  } catch (e) { alert(e.message); }
});

/* ── init ─────────────────────────────────────────────────────────── */

loadSttModels();
loadVoices();

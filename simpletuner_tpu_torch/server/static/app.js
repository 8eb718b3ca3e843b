// Trainer dashboard logic (vanilla JS over the JSON/SSE API).
// Reference behaviors rebuilt: job table + live SSE stream + loss chart
// (trainer dashboard), config form generated from the field registry
// (onboarding wizard / cmd_args parity via /api/fields), dataset plan viewer
// (dataset blueprints), config store browser.

const $ = (sel) => document.querySelector(sel);
const api = async (method, path, body) => {
  const opts = { method, headers: {} };
  const token = localStorage.getItem("st_token");
  if (token) opts.headers["Authorization"] = "Bearer " + token;
  if (body !== undefined) {
    opts.headers["Content-Type"] = "application/json";
    opts.body = JSON.stringify(body);
  }
  const res = await fetch(path, opts);
  let data = null;
  try { data = await res.json(); } catch (e) { /* empty body */ }
  return { status: res.status, data };
};

// ---- bearer token (auth engages once users exist) -------------------------
const tokenInput = $("#token");
tokenInput.value = localStorage.getItem("st_token") || "";
tokenInput.onchange = () => localStorage.setItem("st_token", tokenInput.value.trim());

// ---- tabs -----------------------------------------------------------------
document.querySelectorAll("#tabs button").forEach((btn) => {
  btn.onclick = () => {
    document.querySelectorAll("#tabs button").forEach((b) => b.classList.remove("active"));
    document.querySelectorAll(".tab").forEach((t) => t.classList.remove("active"));
    btn.classList.add("active");
    $("#tab-" + btn.dataset.tab).classList.add("active");
  };
});

// ---- dashboard: jobs ------------------------------------------------------
let logJob = null;
async function refreshJobs() {
  const { data: jobs } = await api("GET", "/api/training/jobs");
  if (!Array.isArray(jobs)) return;
  const tbody = $("#jobs tbody");
  tbody.innerHTML = "";
  for (const j of jobs) {
    const tr = document.createElement("tr");
    tr.innerHTML =
      `<td>${j.job_id}</td><td class="state-${j.state}">${j.state}</td>` +
      `<td>${j.return_code ?? ""}</td><td>${j.output_dir ?? ""}</td>`;
    const td = document.createElement("td");
    const logsBtn = document.createElement("button");
    logsBtn.className = "small ghost";
    logsBtn.textContent = "logs";
    logsBtn.onclick = () => { logJob = j.job_id; refreshLogs(); };
    td.appendChild(logsBtn);
    if (j.state === "running" || j.state === "pending") {
      for (const action of ["checkpoint", "validation", "abort"]) {
        const b = document.createElement("button");
        b.className = "small ghost";
        b.textContent = action;
        b.onclick = () => api("POST", `/api/training/signal/${j.job_id}`, { action });
        td.appendChild(b);
      }
      const c = document.createElement("button");
      c.className = "small";
      c.textContent = "cancel";
      c.onclick = () => api("POST", `/api/training/cancel/${j.job_id}`);
      td.appendChild(c);
    }
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
}
async function refreshLogs() {
  if (!logJob) return;
  $("#log-job").textContent = logJob;
  const { data } = await api("GET", `/api/training/logs/${logJob}?tail=200`);
  if (data && data.logs) {
    const el = $("#logs");
    el.textContent = data.logs.join("\n");
    el.scrollTop = el.scrollHeight;
  }
}
setInterval(refreshJobs, 3000);
setInterval(refreshLogs, 3000);
refreshJobs();

// ---- dashboard: SSE events + loss chart -----------------------------------
const lossSeries = [];
function drawLoss() {
  const canvas = $("#loss-chart");
  const ctx = canvas.getContext("2d");
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  if (lossSeries.length < 2) return;
  const xs = lossSeries.map((p) => p.step);
  const ys = lossSeries.map((p) => p.loss);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const px = (x) => 6 + ((x - xmin) / Math.max(xmax - xmin, 1)) * (canvas.width - 12);
  const py = (y) => canvas.height - 8 - ((y - ymin) / Math.max(ymax - ymin, 1e-9)) * (canvas.height - 16);
  ctx.strokeStyle = "#6ab0f3";
  ctx.lineWidth = 1.5;
  ctx.beginPath();
  lossSeries.forEach((p, i) => (i ? ctx.lineTo(px(p.step), py(p.loss)) : ctx.moveTo(px(p.step), py(p.loss))));
  ctx.stroke();
  ctx.fillStyle = "#8a919d";
  ctx.font = "10px ui-monospace";
  ctx.fillText(`${ymax.toFixed(4)}`, 8, 12);
  ctx.fillText(`${ymin.toFixed(4)}`, 8, canvas.height - 2);
  ctx.fillText(`step ${xmax}`, canvas.width - 70, canvas.height - 2);
}
function connectSSE() {
  const es = new EventSource("/api/events");
  es.onopen = () => ($("#sse-state").textContent = "live");
  es.onerror = () => ($("#sse-state").textContent = "reconnecting…");
  es.onmessage = (e) => {
    const el = $("#events");
    el.textContent += e.data + "\n";
    el.scrollTop = el.scrollHeight;
    try {
      const ev = JSON.parse(e.data);
      const body = ev.event || ev;  // job-forwarded events nest the payload
      if (body && body.event_type === "training_status" && body.loss !== undefined) {
        lossSeries.push({ step: body.global_step ?? lossSeries.length, loss: body.loss });
        if (lossSeries.length > 500) lossSeries.shift();
        $("#loss-job").textContent = ev.job_id || "";
        drawLoss();
      }
    } catch (err) { /* non-JSON keepalive */ }
  };
}
connectSSE();

// ---- new job: form from the field registry --------------------------------
const CORE = ["model_family", "model_type", "optimizer", "learning_rate",
              "max_train_steps", "train_batch_size", "resolution", "lora_rank",
              "output_dir", "seed"];
let fieldDefs = [];
async function buildForm() {
  const [{ data: fields }, { data: models }, { data: optimizers }] = await Promise.all([
    api("GET", "/api/fields"), api("GET", "/api/models"), api("GET", "/api/optimizers"),
  ]);
  fieldDefs = fields || [];
  const mkInput = (f) => {
    let input;
    if (f.name === "model_family" && models) {
      input = document.createElement("select");
      input.innerHTML = "<option value=''></option>" +
        Object.keys(models).map((m) => `<option>${m}</option>`).join("");
    } else if (f.name === "optimizer" && optimizers) {
      input = document.createElement("select");
      input.innerHTML = "<option value=''></option>" +
        optimizers.map((o) => `<option>${o}</option>`).join("");
    } else if (f.choices && f.choices.length) {
      input = document.createElement("select");
      input.innerHTML = "<option value=''></option>" +
        f.choices.map((c) => `<option>${c}</option>`).join("");
    } else if (f.type === "bool") {
      input = document.createElement("select");
      input.innerHTML = "<option value=''></option><option>true</option><option>false</option>";
    } else {
      input = document.createElement("input");
      if (f.default !== null && f.default !== undefined) input.placeholder = String(f.default);
    }
    input.name = f.name;
    input.title = f.help || "";
    return input;
  };
  const wrap = (f) => {
    const div = document.createElement("div");
    const label = document.createElement("label");
    label.textContent = f.name;
    label.title = f.help || "";
    div.appendChild(label);
    div.appendChild(mkInput(f));
    return div;
  };
  const core = $("#core-fields");
  for (const name of CORE) {
    const f = fieldDefs.find((x) => x.name === name);
    if (f) core.appendChild(wrap(f));
  }
  const bySection = {};
  for (const f of fieldDefs) {
    if (CORE.includes(f.name)) continue;
    (bySection[f.section || "other"] ||= []).push(f);
  }
  const host = $("#field-sections");
  for (const [section, fs] of Object.entries(bySection).sort()) {
    const det = document.createElement("details");
    const sum = document.createElement("summary");
    sum.textContent = `${section} (${fs.length})`;
    det.appendChild(sum);
    const grid = document.createElement("div");
    grid.className = "fields";
    fs.forEach((f) => grid.appendChild(wrap(f)));
    det.appendChild(grid);
    host.appendChild(det);
  }
}
buildForm();

function collectConfig() {
  const config = {};
  const typeOf = (name) => (fieldDefs.find((f) => f.name === name) || {}).type;
  for (const input of $("#job-form").querySelectorAll("input[name],select[name]")) {
    const raw = input.value.trim();
    if (!raw) continue;
    const t = typeOf(input.name);
    if (t === "int") config[input.name] = parseInt(raw, 10);
    else if (t === "float") config[input.name] = parseFloat(raw);
    else if (t === "bool") config[input.name] = raw === "true";
    else config[input.name] = raw;
  }
  const mdb = $("#mdb").value.trim();
  if (mdb) config.data_backend_config = JSON.parse(mdb);
  return config;
}

$("#job-form").onsubmit = async (e) => {
  e.preventDefault();
  let config;
  try { config = collectConfig(); } catch (err) {
    $("#submit-result").textContent = "bad dataloader JSON: " + err;
    return;
  }
  const { status, data } = await api("POST", "/api/training/start", { config });
  $("#submit-result").textContent =
    status === 201 ? `submitted: ${data.job_id}` : `error ${status}: ${data && data.error}`;
  if (status === 201) refreshJobs();
};
$("#validate-btn").onclick = async () => {
  let config;
  try { config = collectConfig(); } catch (err) {
    $("#submit-result").textContent = "bad dataloader JSON: " + err;
    return;
  }
  const { data } = await api("POST", "/api/config/validate", { config });
  $("#submit-result").textContent = data.valid ? "config valid" : `invalid: ${data.error}`;
};

// ---- dataset plan viewer ----------------------------------------------------
$("#plan-btn").onclick = async () => {
  $("#plan-error").textContent = "";
  let parsed;
  try { parsed = JSON.parse($("#plan-input").value); } catch (err) {
    $("#plan-error").textContent = "invalid JSON: " + err;
    return;
  }
  const { status, data } = await api("POST", "/api/datasets/plan", { config: parsed });
  if (status !== 200) {
    $("#plan-error").textContent = (data && data.error) || `error ${status}`;
    return;
  }
  const tbody = $("#plan-table tbody");
  tbody.innerHTML = data.datasets.map((d) =>
    `<tr><td>${d.id}</td><td>${d.dataset_type}</td><td>${d.type}</td>` +
    `<td>${d.resolution ?? ""}</td><td>${d.crop ?? ""}</td><td>${d.caption_strategy ?? ""}</td></tr>`
  ).join("");
};

// ---- config store -----------------------------------------------------------
async function refreshConfigs() {
  const { data } = await api("GET", "/api/configs");
  if (!Array.isArray(data)) return;
  const tbody = $("#configs-table tbody");
  tbody.innerHTML = "";
  for (const entry of data) {
    const name = entry.name || entry;
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${name}</td><td>${entry.versions ?? ""}</td>`;
    const td = document.createElement("td");
    const view = document.createElement("button");
    view.className = "small ghost";
    view.textContent = "view";
    view.onclick = async () => {
      const { data: cfg } = await api("GET", `/api/configs/${name}`);
      $("#config-view").textContent = JSON.stringify(cfg, null, 2);
    };
    td.appendChild(view);
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
}
$("#config-save").onclick = async () => {
  const name = $("#config-name").value.trim();
  if (!name) return;
  const config = collectConfig();
  await api("POST", `/api/configs/${name}`, { config });
  refreshConfigs();
};
refreshConfigs();

// ---- dataset sample browser (reference dataset_viewer routes/pages) --------
let viewerOffset = 0;
const VIEWER_PAGE = 24;
async function loadViewer() {
  const dir = $("#viewer-dir").value.trim();
  if (!dir) return;
  const { status, data } = await api("GET",
    `/api/datasets/viewer?dir=${encodeURIComponent(dir)}&offset=${viewerOffset}` +
    `&limit=${VIEWER_PAGE}&thumbnails=1`);
  if (status !== 200) {
    $("#viewer-info").textContent = (data && data.error) || `error ${status}`;
    return;
  }
  $("#viewer-info").textContent =
    `${data.total} samples — showing ${data.offset + 1}-${data.offset + data.samples.length}`;
  $("#viewer-grid").innerHTML = data.samples.map((s) =>
    `<figure title="${s.name}">` +
    (s.thumbnail ? `<img src="${s.thumbnail}">` : `<div class="nofile">${s.name.split(".").pop()}</div>`) +
    `<figcaption>${s.caption ?? ""}</figcaption></figure>`).join("");
}
$("#viewer-btn").onclick = () => { viewerOffset = 0; loadViewer(); };
$("#viewer-prev").onclick = () => { viewerOffset = Math.max(0, viewerOffset - VIEWER_PAGE); loadViewer(); };
$("#viewer-next").onclick = () => { viewerOffset += VIEWER_PAGE; loadViewer(); };

// ---- checkpoints: inventory + inference + prompt libraries -----------------
$("#ckpt-btn").onclick = async () => {
  $("#ckpt-error").textContent = "";
  const dir = $("#ckpt-dir").value.trim();
  const { status, data } = await api("GET",
    `/api/checkpoints?output_dir=${encodeURIComponent(dir)}`);
  if (status !== 200) { $("#ckpt-error").textContent = (data && data.error) || status; return; }
  const tbody = $("#ckpt-table tbody");
  tbody.innerHTML = "";
  for (const c of data) {
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${c.step}</td><td>${c.rolling ? "yes" : ""}</td>` +
      `<td>${c.complete ? "✓" : "partial"}</td><td>${c.artifacts.join(", ")}</td>`;
    const td = document.createElement("td");
    const use = document.createElement("button");
    use.className = "small ghost";
    use.textContent = "render";
    use.onclick = () => { $("#inf-ckpt").value = c.path; };
    td.appendChild(use);
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
};
$("#inf-btn").onclick = async () => {
  const body = {
    checkpoint: $("#inf-ckpt").value.trim(),
    prompt: $("#inf-prompt").value.trim(),
    steps: parseInt($("#inf-steps").value, 10) || 20,
    seed: parseInt($("#inf-seed").value, 10) || 42,
  };
  const res = $("#inf-res").value.trim();
  if (res) body.resolution = parseInt(res, 10);
  const cfg = $("#inf-config").value.trim();
  if (cfg) body.config = cfg;
  const { status, data } = await api("POST", "/api/inference/start", body);
  $("#inf-result").textContent = status === 201
    ? `render job ${data.job_id} started (watch Jobs tab)` : `error: ${data && data.error}`;
  if (status === 201) refreshJobs();
};
async function refreshPromptLibs() {
  const { data } = await api("GET", "/api/prompt-libraries");
  if (!Array.isArray(data)) return;
  const tbody = $("#plib-table tbody");
  tbody.innerHTML = "";
  for (const lib of data) {
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${lib.name}</td><td>${lib.prompts}</td>`;
    const td = document.createElement("td");
    const view = document.createElement("button");
    view.className = "small ghost";
    view.textContent = "edit";
    view.onclick = async () => {
      const { data: entry } = await api("GET", `/api/prompt-libraries/${lib.name}`);
      if (entry && entry.library) {
        $("#plib-name").value = lib.name;
        $("#plib-json").value = JSON.stringify(entry.library, null, 2);
      }
    };
    td.appendChild(view);
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
}
$("#plib-save").onclick = async () => {
  $("#plib-error").textContent = "";
  const name = $("#plib-name").value.trim();
  let library;
  try { library = JSON.parse($("#plib-json").value); } catch (err) {
    $("#plib-error").textContent = "invalid JSON: " + err;
    return;
  }
  const { status, data } = await api("POST", `/api/prompt-libraries/${name}`, { library });
  if (status !== 201) $("#plib-error").textContent = (data && data.error) || status;
  refreshPromptLibs();
};
$("#plib-delete").onclick = async () => {
  const name = $("#plib-name").value.trim();
  if (!name) return;
  await api("DELETE", `/api/prompt-libraries/${name}`);
  refreshPromptLibs();
};
refreshPromptLibs();

// ---- system: hardware + versions + webhook test ----------------------------
const fmtBytes = (n) => (n == null ? "?" : (n / 1e9).toFixed(2) + " GB");
async function refreshSystem() {
  if (!$("#tab-system").classList.contains("active")) return;
  const [{ data: hw }, { data: ver }] = await Promise.all([
    api("GET", "/api/hardware"), api("GET", "/api/version"),
  ]);
  if (hw && hw.accelerators) {
    $("#hw-backend").textContent = hw.backend || "";
    $("#hw-table tbody").innerHTML = hw.accelerators.map((d) =>
      `<tr><td>${d.id}</td><td>${d.kind}</td><td>${d.platform}</td>` +
      `<td>${d.memory ? fmtBytes(d.memory.bytes_in_use) + " / " + fmtBytes(d.memory.bytes_limit) : ""}</td></tr>`
    ).join("");
    $("#host-info").textContent = JSON.stringify(hw.host, null, 2);
  }
  if (ver) $("#version-info").textContent = JSON.stringify(ver, null, 2);
}
$("#wh-btn").onclick = async () => {
  const url = $("#wh-url").value.trim();
  if (!url) return;
  const { status, data } = await api("POST", "/api/webhooks/test", { url });
  $("#wh-result").textContent = status === 200 ? "sent ✓" : `error: ${data && data.error}`;
};
setInterval(refreshSystem, 5000);

// ---- admin: queue / approvals / users / orgs / notifications / pricing ----
function adminError(data, status) {
  $("#admin-error").textContent = data && data.error ? `error ${status}: ${data.error}` : "";
}
async function refreshAdmin() {
  if (!$("#tab-admin").classList.contains("active")) return;
  const [{ data: queue }, { data: approvals }, { data: users },
         { data: orgs }, { data: notifs }, { data: pricing }] = await Promise.all([
    api("GET", "/api/queue"), api("GET", "/api/approvals?state=pending"),
    api("GET", "/api/users"), api("GET", "/api/orgs"),
    api("GET", "/api/notifications"), api("GET", "/api/pricing"),
  ]);
  if (queue && queue.pending) {
    $("#queue-slots").textContent = `${queue.slots_free} slot(s) free`;
    $("#queue-table tbody").innerHTML = queue.pending.map((e) =>
      `<tr><td>${e.job_id}</td><td>${e.owner}</td><td>${e.priority}</td>` +
      `<td>${new Date(e.submitted_at * 1000).toLocaleTimeString()}</td></tr>`).join("");
    $("#usage-table tbody").innerHTML =
      Object.entries(queue.fair_share_usage_seconds || {}).map(([u, s]) =>
        `<tr><td>${u}</td><td>${s.toFixed(1)}</td></tr>`).join("");
  }
  if (Array.isArray(approvals)) {
    const tbody = $("#approvals-table tbody");
    tbody.innerHTML = "";
    for (const a of approvals) {
      const tr = document.createElement("tr");
      tr.innerHTML = `<td>${a.approval_id}</td><td>${a.owner}</td>` +
        `<td>${(a.config || {}).model_family ?? ""}</td><td>${a.priority}</td>`;
      const td = document.createElement("td");
      for (const action of ["approve", "reject"]) {
        const b = document.createElement("button");
        b.className = "small" + (action === "reject" ? " ghost" : "");
        b.textContent = action;
        b.onclick = async () => {
          const { status, data } = await api("POST", `/api/approvals/${a.approval_id}/${action}`, {});
          adminError(data, status);
          refreshAdmin();
        };
        td.appendChild(b);
      }
      tr.appendChild(td);
      tbody.appendChild(tr);
    }
  }
  if (Array.isArray(users)) {
    $("#users-table tbody").innerHTML = users.map((u) =>
      `<tr><td>${u.username}</td><td>${u.role}</td>` +
      `<td>${u.usage.jobs_submitted}</td><td>${u.usage.steps_requested}</td>` +
      `<td>$${(u.usage.spend_usd || 0).toFixed(2)}</td></tr>`).join("");
  }
  if (Array.isArray(orgs)) {
    $("#orgs-table tbody").innerHTML = orgs.map((o) =>
      `<tr><td>${o.name}</td><td>${Object.keys(o.members).join(", ")}</td>` +
      `<td>${o.require_approval ? "yes" : "no"}</td>` +
      `<td>$${(o.usage.spend_usd || 0).toFixed(2)}</td></tr>`).join("");
  }
  if (Array.isArray(notifs)) {
    $("#notifications").textContent = notifs.slice(-50).map((n) =>
      `${n.read ? " " : "*"} [${n.kind}] ${n.title}`).join("\n");
  }
  if (pricing && !pricing.error) {
    $("#pricing-table tbody").innerHTML = Object.entries(pricing).sort().map(([a, r]) =>
      `<tr><td>${a}</td><td>$${r.toFixed(2)}</td></tr>`).join("");
  }
}
$("#user-create").onclick = async () => {
  const username = $("#new-user").value.trim();
  if (!username) return;
  const { status, data } = await api("POST", "/api/users",
    { username, role: $("#new-user-role").value });
  adminError(data, status);
  if (status === 201) $("#user-token").textContent = `token: ${data.token}`;
  refreshAdmin();
};
$("#org-create").onclick = async () => {
  const name = $("#new-org").value.trim();
  if (!name) return;
  const { status, data } = await api("POST", "/api/orgs", {
    name, owner: $("#new-org-owner").value.trim() || undefined,
    require_approval: $("#new-org-approval").checked,
  });
  adminError(data, status);
  refreshAdmin();
};
$("#notif-read").onclick = async () => { await api("POST", "/api/notifications/read", {}); refreshAdmin(); };
$("#price-set").onclick = async () => {
  const { status, data } = await api("POST", "/api/pricing", {
    accelerator_type: $("#price-accel").value.trim(),
    usd_per_chip_hour: parseFloat($("#price-rate").value),
  });
  adminError(data, status);
  refreshAdmin();
};
setInterval(refreshAdmin, 4000);
refreshAdmin();

// ---- themes (reference routes/themes.py + theme_service) --------------------
async function initThemes() {
  const { data: themes } = await api("GET", "/api/themes");
  if (!Array.isArray(themes)) return;
  const sel = $("#theme-select");
  sel.innerHTML = themes.map((t) => `<option value="${t.id}">${t.name}</option>`).join("");
  const saved = localStorage.getItem("st_theme") || "dark";
  sel.value = saved;
  applyTheme(saved);
  sel.onchange = () => { localStorage.setItem("st_theme", sel.value); applyTheme(sel.value); };
}
function applyTheme(id) {
  let link = document.getElementById("theme-css");
  if (!link) {
    link = document.createElement("link");
    link.id = "theme-css";
    link.rel = "stylesheet";
    document.head.appendChild(link);
  }
  link.href = `/api/themes/${id}/theme.css`;
}
initThemes();

// ---- dashboard: lr + throughput charts (reference trainer dashboard charts) -
const lrSeries = [];
const ipsSeries = [];
let lastStepTime = null;
function drawSeries(canvasId, series, key, fmt) {
  const canvas = $(canvasId);
  if (!canvas) return;
  const ctx = canvas.getContext("2d");
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  if (series.length < 2) return;
  const xs = series.map((p) => p.step);
  const ys = series.map((p) => p[key]);
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const px = (x) => 6 + ((x - xmin) / Math.max(xmax - xmin, 1)) * (canvas.width - 12);
  const py = (y) => canvas.height - 8 - ((y - ymin) / Math.max(ymax - ymin, 1e-12)) * (canvas.height - 16);
  ctx.strokeStyle = getComputedStyle(document.body).getPropertyValue("--accent") || "#6ab0f3";
  ctx.lineWidth = 1.5;
  ctx.beginPath();
  series.forEach((p, i) => (i ? ctx.lineTo(px(p.step), py(p[key])) : ctx.moveTo(px(p.step), py(p[key]))));
  ctx.stroke();
  ctx.fillStyle = "#8a919d";
  ctx.font = "10px ui-monospace";
  ctx.fillText(fmt(ymax), 8, 12);
  ctx.fillText(fmt(ymin), 8, canvas.height - 2);
}
// feed lr/throughput from the same SSE training_status events the loss chart
// uses (helpers in connectSSE push into lossSeries; hook the stream again)
(function hookMetrics() {
  const es = new EventSource("/api/events");
  es.onmessage = (e) => {
    try {
      const ev = JSON.parse(e.data);
      const body = ev.event || ev;
      if (body && body.event_type === "training_status") {
        const step = body.global_step ?? 0;
        if (body.lr !== undefined) {
          lrSeries.push({ step, lr: body.lr });
          if (lrSeries.length > 500) lrSeries.shift();
          drawSeries("#lr-chart", lrSeries, "lr", (v) => v.toExponential(1));
        }
        const now = Date.now() / 1000;
        if (lastStepTime !== null && now > lastStepTime) {
          ipsSeries.push({ step, ips: 1.0 / (now - lastStepTime) });
          if (ipsSeries.length > 500) ipsSeries.shift();
          drawSeries("#ips-chart", ipsSeries, "ips", (v) => v.toFixed(2));
        }
        lastStepTime = now;
      }
    } catch (err) { /* keepalive */ }
  };
})();

// ---- managed datasets (reference routes/datasets.py + dataset_viewer.py) ----
async function refreshManaged() {
  const { status, data } = await api("GET", "/api/datasets/browse");
  if (status !== 200) return;
  $("#ds-path").textContent = data.root;
  const tbody = $("#ds-table tbody");
  tbody.innerHTML = "";
  for (const d of data.directories) {
    const tr = document.createElement("tr");
    tr.innerHTML = `<td>${d.name}</td><td class="ds-files">…</td><td class="ds-type"></td>` +
      `<td class="ds-caps"></td><td class="ds-buckets"></td>`;
    const td = document.createElement("td");
    const inspect = document.createElement("button");
    inspect.className = "small ghost";
    inspect.textContent = "inspect";
    inspect.onclick = async () => {
      const { data: s } = await api("GET", `/api/datasets/viewer/summary?path=${encodeURIComponent(d.name)}`);
      if (!s) return;
      tr.querySelector(".ds-files").textContent = Object.values(s.counts || {}).reduce((a, b) => a + b, 0);
      tr.querySelector(".ds-type").textContent = s.dataset_type;
      tr.querySelector(".ds-caps").textContent = `${Math.round((s.caption_coverage || 0) * 100)}%`;
      tr.querySelector(".ds-buckets").textContent = s.buckets ? Object.keys(s.buckets).length : "unscanned";
      $("#viewer-dir").value = `${$("#ds-path").textContent}/${d.name}`;
    };
    const scan = document.createElement("button");
    scan.className = "small ghost";
    scan.textContent = "scan";
    scan.onclick = async () => {
      const res = $("#wiz-res") ? parseInt($("#wiz-res").value, 10) || 1024 : 1024;
      await api("POST", "/api/datasets/scan", { dir: d.name, resolution: res });
      tr.querySelector(".ds-buckets").textContent = "scanning…";
    };
    td.appendChild(inspect);
    td.appendChild(scan);
    tr.appendChild(td);
    tbody.appendChild(tr);
  }
}
$("#ds-refresh").onclick = refreshManaged;
$("#ds-mkdir").onclick = async () => {
  const name = $("#ds-new-folder").value.trim();
  if (!name) return;
  await api("POST", "/api/datasets/folders", { name });
  refreshManaged();
};
async function uploadFiles(dir, fileList, resultEl) {
  if (!dir || !fileList.length) {
    resultEl.textContent = "pick a folder and files first";
    return false;
  }
  const form = new FormData();
  for (const f of fileList) form.append("file", f, f.name);
  const headers = {};
  const token = localStorage.getItem("st_token");
  if (token) headers["Authorization"] = "Bearer " + token;
  const zip = fileList.length === 1 && fileList[0].name.endsWith(".zip");
  const url = zip
    ? `/api/datasets/upload/zip?dir=${encodeURIComponent(dir)}`
    : `/api/datasets/upload?dir=${encodeURIComponent(dir)}`;
  const res = await fetch(url, { method: "POST", headers, body: zip ? fileList[0] : form });
  const data = await res.json();
  resultEl.textContent = res.status === 201
    ? `uploaded ${data.extracted ?? (data.uploaded || []).length} file(s) ✓`
    : `error: ${data && data.error}`;
  return res.status === 201;
}
$("#ds-upload").onclick = () =>
  uploadFiles($("#ds-upload-dir").value.trim(), $("#ds-upload-files").files, $("#ds-upload-result"))
    .then((ok) => ok && refreshManaged());
$("#cap-load").onclick = async () => {
  const { data } = await api("GET",
    `/api/datasets/captions/get?path=${encodeURIComponent($("#cap-dir").value.trim())}` +
    `&file=${encodeURIComponent($("#cap-file").value.trim())}`);
  $("#cap-text").value = (data && data.caption) || "";
  $("#cap-result").textContent = data && data.source ? `from ${data.source}` : "no caption yet";
};
$("#cap-save").onclick = async () => {
  const { status, data } = await api("POST", "/api/datasets/captions", {
    path: $("#cap-dir").value.trim(), file: $("#cap-file").value.trim(),
    text: $("#cap-text").value,
  });
  $("#cap-result").textContent = status === 201 ? "saved ✓" : `error: ${data && data.error}`;
};
refreshManaged();

// ---- onboarding wizard (reference onboarding templates flow) ----------------
let wizDataset = null;
function wizShow(step) {
  for (let i = 1; i <= 4; i++) $(`#wiz-step-${i}`).hidden = i !== step;
  $("#wiz-step-label").textContent = `step ${step} of 4`;
}
$("#wiz-upload").onclick = async () => {
  const dir = $("#wiz-folder").value.trim() || "my-dataset";
  const ok = await uploadFiles(dir, $("#wiz-files").files, $("#wiz-upload-result"));
  if (ok) {
    wizDataset = dir;
    $("#wiz-to-2").disabled = false;
  }
};
$("#wiz-to-2").onclick = async () => {
  wizShow(2);
  const { data } = await api("GET", `/api/datasets/detect?path=${encodeURIComponent(wizDataset)}`);
  $("#wiz-detect").textContent = JSON.stringify(data, null, 2);
};
$("#wiz-scan").onclick = async () => {
  const { data: rec } = await api("POST", "/api/datasets/scan", { dir: wizDataset, resolution: 1024 });
  $("#wiz-scan-result").textContent = "scanning…";
  const poll = setInterval(async () => {
    const { data: info } = await api("GET", `/api/datasets/scan/status?scan_id=${rec.scan_id}`);
    if (info && info.state === "completed") {
      clearInterval(poll);
      $("#wiz-scan-result").textContent =
        `${info.total_files} files in ${Object.keys(info.buckets).length} bucket(s) ✓`;
      $("#wiz-to-3").disabled = false;
    } else if (info && info.state === "failed") {
      clearInterval(poll);
      $("#wiz-scan-result").textContent = "scan failed: " + info.error;
    }
  }, 700);
};
$("#wiz-to-3").onclick = async () => {
  wizShow(3);
  const { data: models } = await api("GET", "/api/models");
  $("#wiz-family").innerHTML = Object.keys(models || {}).map((m) => `<option>${m}</option>`).join("");
  $("#wiz-family").value = "flux";
};
function wizBuildConfig() {
  const root = $("#ds-path").textContent || "";
  const dataDir = `${root}/${wizDataset}`;
  const res = parseInt($("#wiz-res").value, 10) || 1024;
  return {
    model_family: $("#wiz-family").value,
    model_type: $("#wiz-type").value,
    ...($("#wiz-type").value === "lora" ? { lora_rank: 16 } : {}),
    resolution: res, resolution_type: "pixel_area",
    train_batch_size: 1,
    max_train_steps: parseInt($("#wiz-steps").value, 10) || 1000,
    learning_rate: parseFloat($("#wiz-lr").value) || 1e-4,
    optimizer: "adamw", seed: 42, report_to: "none",
    output_dir: $("#wiz-out").value.trim() || "output/wizard-run",
    data_backend_config: [
      { id: wizDataset, type: "local", instance_data_dir: dataDir,
        resolution: res, resolution_type: "pixel_area",
        caption_strategy: "textfile", text_embeds: "embeds" },
      { id: "embeds", dataset_type: "text_embeds", type: "local",
        default: true, cache_dir: `cache/${wizDataset}/text` },
    ],
  };
}
$("#wiz-review").onclick = () => {
  wizShow(4);
  $("#wiz-config").textContent = JSON.stringify(wizBuildConfig(), null, 2);
};
$("#wiz-launch").onclick = async () => {
  const config = JSON.parse($("#wiz-config").textContent);
  const name = $("#wiz-config-name").value.trim();
  if (name) await api("POST", `/api/configs/${name}`, { config });
  const { status, data } = await api("POST", "/api/training/start", { config });
  $("#wiz-launch-result").textContent = status === 201
    ? `training started: ${data.job_id} (see Dashboard)` : `error: ${data && data.error}`;
};
wizShow(1);

// ---- git config versioning panel (reference routes/git.py) ------------------
async function refreshGit() {
  const { data: st } = await api("GET", "/api/git/status");
  if (!st) return;
  $("#git-state").textContent = !st.git_available ? "git unavailable"
    : !st.repo_present ? "no repo"
    : `${st.branch || "?"} · ${st.dirty_paths.length} dirty`;
  const { data: hist } = await api("GET", "/api/git/history");
  if (Array.isArray(hist)) {
    const tbody = $("#git-history tbody");
    tbody.innerHTML = "";
    for (const h of hist) {
      const tr = document.createElement("tr");
      tr.innerHTML = `<td>${h.commit.slice(0, 8)}</td>` +
        `<td>${new Date(h.timestamp * 1000).toLocaleString()}</td><td>${h.message}</td>`;
      const td = document.createElement("td");
      const diffBtn = document.createElement("button");
      diffBtn.className = "small ghost";
      diffBtn.textContent = "diff";
      diffBtn.onclick = async () => {
        const { data } = await api("GET", `/api/git/diff?commit=${h.commit}`);
        $("#git-diff").textContent = (data && data.diff) || "(no diff)";
      };
      const revertBtn = document.createElement("button");
      revertBtn.className = "small ghost";
      revertBtn.textContent = "revert to";
      revertBtn.onclick = async () => {
        const { status, data } = await api("POST", "/api/git/revert", { path: ".", commit: h.commit });
        $("#git-result").textContent = status === 200 ? "reverted ✓" : `error: ${data && data.error}`;
        refreshGit();
      };
      td.appendChild(diffBtn);
      td.appendChild(revertBtn);
      tr.appendChild(td);
      tbody.appendChild(tr);
    }
  }
}
$("#git-init").onclick = async () => { await api("POST", "/api/git/init", {}); refreshGit(); };
$("#git-snapshot").onclick = async () => {
  const { status, data } = await api("POST", "/api/git/snapshot",
    { message: $("#git-msg").value.trim() || undefined });
  $("#git-result").textContent = status === 201
    ? (data.committed ? `committed ${data.commit.slice(0, 8)} ✓` : data.reason)
    : `error: ${data && data.error}`;
  refreshGit();
};
$("#git-refresh").onclick = refreshGit;
refreshGit();
